"""ctypes bindings of the native batch loader (``dataloader.cc``): counterpart
of ``diff_pruning_tpu/native/__init__.py``.

The library builds on first use (``g++ -O3 -march=native -fopenmp``, the JAX
version's flags) into ``BUILD_DIR``, named by a digest of the source, the
flags and what ``-march=native`` means on this host (g++'s target options),
as ``ops/_build.py`` names the kernels; ``BUILD_DIR`` is listed in
``.gitignore``. So a library built on another CPU is never loaded here. A failed build or load raises: nothing gives way to the
NumPy/PIL path, whose pixels differ from the native resize's.

``assemble_batch`` gathers, flips and maps an in-memory set to [-1, 1] in
C. ``decode_batch`` decodes each file with PIL (PNG is lossless, and PIL's
libjpeg decodes a baseline JPEG as the system's does) and resizes and crops
them all in C with the JAX decoder's bilinear filter, so a resized folder
gives the JAX package's native pixels. The JPEG and PNG decoders themselves
are not compiled here: libjpeg's and libpng's headers are missing on the
H100 machine. As in JAX, a file that the native decoder would refuse (not a
PNG under a .png name, else not a JPEG, an undecodable one, a CMYK JPEG)
makes the whole batch return None, and the caller decodes that batch with
PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dataloader.cc")
BUILD_DIR = os.path.join(_HERE, "build")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
# calls of each entry point that ran the C loop (chip_smoke.py reads them)
CALLS = {"assemble_batch": 0, "decode_batch": 0}

_lock = threading.Lock()
_lib = None


def _host_target() -> str:
    """g++'s target options under ``CXX_FLAGS`` on this host: the instruction
    sets that ``-march=native`` enables here."""
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native batch loader is built "
                           "from source on first use") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ -Q --help=target failed:\n{res.stderr}")
    return res.stdout


def get_lib() -> ctypes.CDLL:
    """Load the library, building it if it is missing; raises if either fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        with open(_SRC, "rb") as f:
            h.update(f.read())
        h.update(" ".join(CXX_FLAGS).encode())
        h.update(_host_target().encode())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libdataloader-{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                res = subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp],
                                     capture_output=True, text=True, timeout=240)
            except FileNotFoundError as e:
                raise RuntimeError("g++ not found: the native batch loader is built "
                                   "from source on first use") from e
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {_SRC}:\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.assemble_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        lib.assemble_batch.restype = None
        lib.resize_crop_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p]
        lib.resize_crop_batch.restype = None
        lib.omp_thread_count.restype = ctypes.c_int
        _lib = lib
        return lib


def assemble_batch(images: np.ndarray, indices: np.ndarray, flip: np.ndarray) -> np.ndarray:
    """(n, h, w, c) uint8 + indices + flip flags -> (b, h, w, c) float32 in [-1, 1]."""
    lib = get_lib()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    fl = np.ascontiguousarray(flip, dtype=np.uint8)
    n, h, w, c = images.shape
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"indices outside [0, {n})")
    out = np.empty((len(idx), h, w, c), dtype=np.float32)
    lib.assemble_batch(images.ctypes.data, n, h, w, c, idx.ctypes.data, fl.ctypes.data,
                       len(idx), out.ctypes.data)
    CALLS["assemble_batch"] += 1
    return out


def _decode(path: str) -> Optional[np.ndarray]:
    """RGB uint8 of a file that the JAX native decoder takes (a PNG by its
    suffix, else a JPEG), or None where it would fail."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            # PIL names the format from the file's bytes, not its name
            if im.format != ("PNG" if path.lower().endswith(".png") else "JPEG") \
                    or im.mode == "CMYK":
                return None
            if im.mode.startswith("I;16"):  # 16-bit grey: libpng keeps the high byte
                g = (np.asarray(im).astype(np.uint16) >> 8).astype(np.uint8)
                return np.repeat(g[..., None], 3, axis=-1)
            return np.ascontiguousarray(np.asarray(im.convert("RGB"), dtype=np.uint8))
    except (OSError, ValueError, SyntaxError):
        return None


def decode_batch(paths: Sequence[str], resolution: int) -> Optional[np.ndarray]:
    """Decode ``paths`` (PIL, one after another: on the H100 machine's host a
    thread pool made the decode 2-3x slower), then resize the shorter side
    to ``resolution`` and centre-crop (bilinear, in C, a thread an image):
    (b, res, res, 3) uint8, or None if any file would fail the JAX native
    decoder."""
    lib = get_lib()
    imgs = []
    for path in paths:
        imgs.append(_decode(path))
        if imgs[-1] is None:
            return None
    b = len(imgs)
    ptrs = (ctypes.c_void_p * b)(*[im.ctypes.data for im in imgs])
    ws = np.array([im.shape[1] for im in imgs], np.int32)
    hs = np.array([im.shape[0] for im in imgs], np.int32)
    out = np.empty((b, resolution, resolution, 3), dtype=np.uint8)
    lib.resize_crop_batch(ptrs, ws.ctypes.data, hs.ctypes.data, b, resolution,
                          out.ctypes.data)
    CALLS["decode_batch"] += 1
    return out
