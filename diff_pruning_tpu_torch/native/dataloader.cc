// Native host-side batch loader of diff_pruning_tpu_torch: counterpart of
// diff_pruning_tpu/native/dataloader.cc, without its JPEG and PNG decoders
// (they need libjpeg's and libpng's headers, which the H100 machine lacks).
//
// Two OpenMP loops behind a C ABI, loaded with ctypes (native/__init__.py
// builds this file on first use with g++ -O3 -march=native -fopenmp, the
// JAX version's flags, so that its arithmetic rounds alike):
//   assemble_batch      gather + horizontal flip + [-1, 1] of an in-memory set;
//   resize_crop_batch   the JAX decoder's bilinear shorter-side resize and
//                       centre crop, over images that the caller decoded.

#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {
constexpr int64_t kParallelValues = int64_t{1} << 21;
}  // namespace

extern "C" {

// Gather `batch` images from an (n, h, w, c) uint8 array by index, flip
// horizontally where flip[i] != 0, and write float32 in [-1, 1].
void assemble_batch(const uint8_t* images, int64_t n, int64_t h, int64_t w,
                    int64_t c, const int64_t* indices, const uint8_t* flip,
                    int64_t batch, float* out) {
  (void)n;
  const int64_t img_sz = h * w * c;
  // below ~2M values one thread is faster: waking the team costs more than
  // the copy (CIFAR's B = 128 on an H100 machine's 8-core host: 0.39 ms on one
  // thread, 3.2 ms on eight)
#pragma omp parallel for schedule(static) if (batch * img_sz >= kParallelValues)
  for (int64_t i = 0; i < batch; ++i) {
    const uint8_t* src = images + indices[i] * img_sz;
    float* dst = out + i * img_sz;
    if (!flip[i]) {
      for (int64_t j = 0; j < img_sz; ++j)
        dst[j] = src[j] / 127.5f - 1.0f;  // f32 division matches numpy exactly
    } else {
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* row = src + y * w * c;
        float* orow = dst + y * w * c;
        for (int64_t x = 0; x < w; ++x) {
          const uint8_t* px = row + (w - 1 - x) * c;
          float* opx = orow + x * c;
          for (int64_t k = 0; k < c; ++k)
            opx[k] = px[k] / 127.5f - 1.0f;
        }
      }
    }
  }
}

namespace {

// Bilinear resize (RGB uint8, shorter side to res) then centre crop to
// res x res: the JAX decoder's resize_center_crop, with each column's
// source pixels and weight computed once (the same expressions) instead of
// once a row.
void resize_center_crop(const uint8_t* src, int w, int h, int res,
                        uint8_t* dst) {
  double s = static_cast<double>(res) / std::min(w, h);
  int nw = std::max(res, static_cast<int>(w * s + 0.5));
  int nh = std::max(res, static_cast<int>(h * s + 0.5));
  int x0 = (nw - res) / 2, y0 = (nh - res) / 2;
  std::vector<int> ixs(res), ix1s(res);
  std::vector<double> wxs(res);
  for (int x = 0; x < res; ++x) {
    double fx = (x + x0 + 0.5) * w / nw - 0.5;
    int ix = static_cast<int>(fx < 0 ? 0 : fx);
    ixs[x] = ix;
    ix1s[x] = std::min(ix + 1, w - 1);
    double wx = fx - ix;
    wxs[x] = wx < 0 ? 0 : wx;
  }
  for (int y = 0; y < res; ++y) {
    double fy = (y + y0 + 0.5) * h / nh - 0.5;
    int iy = static_cast<int>(fy < 0 ? 0 : fy);
    int iy1 = std::min(iy + 1, h - 1);
    double wy = fy - iy;
    if (wy < 0) wy = 0;
    for (int x = 0; x < res; ++x) {
      const int ix = ixs[x], ix1 = ix1s[x];
      const double wx = wxs[x];
      for (int k = 0; k < 3; ++k) {
        double v00 = src[(iy * w + ix) * 3 + k];
        double v01 = src[(iy * w + ix1) * 3 + k];
        double v10 = src[(iy1 * w + ix) * 3 + k];
        double v11 = src[(iy1 * w + ix1) * 3 + k];
        double v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                   wy * ((1 - wx) * v10 + wx * v11);
        dst[(y * res + x) * 3 + k] = static_cast<uint8_t>(v + 0.5);
      }
    }
  }
}

}  // namespace

// Resize + centre crop `batch` decoded RGB uint8 images (srcs[i] is
// hs[i] x ws[i] x 3, contiguous) into out (batch, res, res, 3).
void resize_crop_batch(const uint8_t* const* srcs, const int32_t* ws,
                       const int32_t* hs, int64_t batch, int32_t res,
                       uint8_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < batch; ++i)
    resize_center_crop(srcs[i], ws[i], hs[i], res,
                       out + i * static_cast<int64_t>(res) * res * 3);
}

// The threads each loop runs on (OMP_NUM_THREADS, else the cores).
int omp_thread_count() { return omp_get_max_threads(); }

}  // extern "C"
