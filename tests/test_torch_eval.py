"""The port's evaluation slice against the JAX package, on the CPU: the FID
Inception, FID, the fidelity metrics (IS, KID, precision/recall), SSIM, the
procedural data, the image-folder loader and the fid_score, fidelity and
compute_ssim CLIs.

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs with f32 matmuls (its convolutions are at HIGHEST precision
anyway). Each tolerance is stated where it is used:

- pool3 features: relative error in norm <= 1e-5. Both sides compute in f32
  and differ only in summation order through 94 convolutions (measured
  ~3e-7);
- anything host numpy that the port copies (the random init, resize
  matrices, statistics, the Fréchet distance of given statistics, the
  procedural data, decoded folders): bit-identical;
- metrics of features, each at its own tolerance below.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from diff_pruning_tpu.eval import fid as jfid
from diff_pruning_tpu.eval import fidelity as jfidelity
from diff_pruning_tpu.eval import inception as jinc
from diff_pruning_tpu.eval import resize as jresize
from diff_pruning_tpu.eval import ssim as jssim
from diff_pruning_tpu_torch.eval import fid as tfid
from diff_pruning_tpu_torch.eval import fidelity as tfidelity
from diff_pruning_tpu_torch.eval import inception as tinc
from diff_pruning_tpu_torch.eval import resize as tresize
from diff_pruning_tpu_torch.eval import ssim as tssim

torch.set_num_threads(2)
FEATURE_RTOL = 1e-5


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _fc_head(seed):
    """A seeded 1008-way head in the pt_inception layout."""
    rng = np.random.default_rng(seed)
    return {"fc.weight": torch.from_numpy(rng.standard_normal((1008, 2048)).astype(np.float32)
                                          * 0.02),
            "fc.bias": torch.from_numpy(rng.standard_normal(1008).astype(np.float32) * 0.1)}


def test_inception_matches_jax(tmp_path):
    """The random init equals the JAX one bit for bit (through the bridge
    and through the JAX converter); pool3 features match JAX's
    ``inception_pool3`` in both resize modes, on an upscale (32 -> 299) and
    a downscale (512 -> 299), and with ``resize=False``; a ``.pth`` and a
    JAX-layout ``.npz`` load to the same weights and features; and
    ``inception_probs`` matches (probabilities to 1e-5 relative in norm:
    one f32 product and softmax on each side)."""
    from diff_pruning_tpu.utils.checkpoint import save_params_npz

    sd = tinc.random_init_fid_inception_state_dict(0)
    jparams = jinc.random_init_fid_inception_params(0)
    bridged = tinc.state_dict_from_jax_inception_params(jparams)
    assert bridged.keys() == sd.keys()
    assert all(torch.equal(bridged[k], sd[k]) for k in sd)
    again = jinc.torch_inception_state_dict_to_params(sd)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(again),
                                                     jax.tree_util.tree_leaves(jparams)))
    model = tinc.fid_inception(sd)

    rng = np.random.default_rng(0)
    jpool3 = jax.jit(jinc.inception_pool3, static_argnames=("resize",))
    for hw, mode in ((32, "torch"), (512, "torch"), (32, "clean"), (512, "clean"),
                     (299, "no resize")):
        x = rng.random((2, hw, hw, 3)).astype(np.float32)
        resize = mode == "torch"
        with jax.default_matmul_precision("float32"):
            jx = jnp.asarray(x)
            if mode == "clean":
                jx = jresize.resize_bicubic_pil(jx, 299, 299)
            want = np.asarray(jpool3(jparams, jx, resize=resize))
        tx = torch.from_numpy(x)
        if mode == "clean":
            tx = tresize.resize_bicubic_pil(tx, 299, 299)
        with torch.inference_mode():
            got = tinc.inception_pool3(model, tx, resize=resize).numpy()
        assert got.shape == (2, 2048) and np.isfinite(got).all()
        assert _rel(got, want) <= FEATURE_RTOL, (hw, mode, _rel(got, want))

    # the same weights from a .pth (pt_inception layout, with an fc head and
    # the auxiliary classifier it drops) and from a JAX-converted .npz
    head = _fc_head(1)
    pth = str(tmp_path / "w.pth")
    torch.save({**sd, **head, "AuxLogits.fc.weight": torch.zeros(1000, 768)}, pth)
    npz = str(tmp_path / "w.npz")
    jwith_fc = jinc.torch_inception_state_dict_to_params({**sd, **head})
    save_params_npz(npz, jwith_fc)
    from_pth = tinc.load_fid_inception_state_dict(pth)
    from_npz = tinc.load_fid_inception_state_dict(npz)
    assert from_pth.keys() == from_npz.keys() == {**sd, **head}.keys()
    assert all(torch.equal(from_pth[k], from_npz[k]) for k in from_pth)
    x = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        feats = [tinc.inception_pool3(tinc.fid_inception(s), x) for s in (from_pth, from_npz)]
    assert torch.equal(*feats)

    pool3 = rng.standard_normal((16, 2048)).astype(np.float32)
    for unbiased in (True, False):
        want = jfidelity.inception_probs(jwith_fc, pool3, unbiased=unbiased)
        got = tfidelity.inception_probs(tinc.fid_inception(from_pth), pool3, unbiased=unbiased)
        assert _rel(got, want) <= 1e-5, unbiased
    with pytest.raises(ValueError, match="fc head"):
        tfidelity.inception_probs(model, pool3)


def test_fid_and_fidelity_metrics_match_jax(tmp_path, capsys):
    """On seeded features: the resize matrices equal JAX's and the clean
    resize matches it (1e-5 relative in norm: two f32 products a side);
    statistics, the Fréchet distance of given statistics and ISC of given
    probabilities are bit-identical (the same host numpy); KID (1e-6 of
    the mean kernel value: an f32 difference of kernel means on each side)
    and precision/recall (within one sample, 1/N: a point at a near-tie
    distance may fall on either side of the radius) match JAX's; stats
    files written by either package load in the other; the resize-mode
    warning appears. SSIM, per image and averaged, within 1e-5 of JAX's
    (both f32, the JAX side at HIGHEST precision: the 11 x 11 filters sum
    in other orders), 1 for identical images; pairwise_ssim_mse of two
    folders within 1e-5 too."""
    rng = np.random.default_rng(3)
    for hw in ((32, 32), (300, 200)):
        for out in ((299, 299), (64, 48)):
            assert np.array_equal(tresize.resize_weights(hw[0], out[0]),
                                  jresize.resize_weights(hw[0], out[0]))
            x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
            with jax.default_matmul_precision("float32"):
                want = np.asarray(jresize.resize_bicubic_pil(jnp.asarray(x), *out))
            got = tresize.resize_bicubic_pil(torch.from_numpy(x), *out).numpy()
            assert _rel(got, want) <= 1e-5, (hw, out)

    f1 = rng.standard_normal((300, 64))
    f2 = rng.standard_normal((200, 64)) * 1.2 + 0.2
    s_t, s_j = tfid.activation_statistics(f1), jfid.activation_statistics(f1)
    assert all(np.array_equal(a, b) for a, b in zip(s_t, s_j))
    s2 = tfid.activation_statistics(f2)
    assert tfid.frechet_distance(*s_t, *s2) == jfid.frechet_distance(*s_j, *s2)

    feats1 = rng.standard_normal((300, 2048)).astype(np.float32)
    feats2 = (rng.standard_normal((240, 2048)) * 1.1 + 0.05).astype(np.float32)
    logits = rng.standard_normal((300, 1008)) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for split_kw in ({}, {"splits": 7, "seed": 4}):
        got = tfidelity.inception_score(probs, **split_kw)
        want = jfidelity.inception_score(probs, **split_kw)
        assert got == want, split_kw  # the same numpy on the same probabilities
    with jax.default_matmul_precision("float32"):
        for kw in ({}, {"subset_size": 50, "subsets": 7, "seed": 2}):
            got = tfidelity.kid(feats1, feats2, **kw)
            want = jfidelity.kid(feats1, feats2, **kw)
            scale = float(np.mean((feats1 @ feats2.T / 2048 + 1.0) ** 3))
            assert abs(got[0] - want[0]) <= 1e-6 * scale, (kw, got, want)
            assert abs(got[1] - want[1]) <= 1e-6 * scale, (kw, got, want)
        # 16-d features, where the two manifolds overlap in part
        real = rng.standard_normal((300, 16)).astype(np.float32)
        gen = (rng.standard_normal((240, 16)) * 1.3 + 0.3).astype(np.float32)
        for k, chunk in ((3, 4096), (5, 64)):
            got = tfidelity.precision_recall(real, gen, k=k, row_chunk=chunk)
            want = jfidelity.precision_recall(real, gen, k=k, row_chunk=chunk)
            assert 0.0 < want["precision"] < 1.0 and 0.0 < want["recall"] < 1.0, want
            for key in ("precision", "recall"):
                assert abs(got[key] - want[key]) <= 1.0 / 240, (k, key, got, want)

    a = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.15 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    for size_average in (True, False):
        got = tssim.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=size_average)
        want = np.asarray(jssim.ssim(jnp.asarray(a), jnp.asarray(b),
                                     size_average=size_average))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float(tssim.ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(
        1.0, abs=1e-6)
    u8 = (rng.uniform(0, 1, (5, 24, 24, 3)) * 255).astype(np.uint8)
    u8b = np.clip(u8.astype(int) + rng.integers(-40, 40, u8.shape), 0, 255).astype(np.uint8)
    da, db = _write_folder(str(tmp_path / "sa"), u8), _write_folder(str(tmp_path / "sb"), u8b)
    got = tssim.pairwise_ssim_mse(da, db, batch_size=2)
    want = jssim.pairwise_ssim_mse(da, db, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert tssim.pairwise_ssim_mse(da, da)[0] == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="no matching filenames"):
        tssim.pairwise_ssim_mse(da, _write_folder(str(tmp_path / "sc"), []))

    # stats files cross the packages both ways, and a mode mismatch warns
    mu, sigma = s_t
    for writer, reader in ((tfid.save_stats, jfid.statistics_of_path),
                           (jfid.save_stats, tfid.statistics_of_path)):
        path = str(tmp_path / f"{writer.__module__.split('.')[0]}.npz")
        writer(path, mu, sigma, resize_mode="clean")
        capsys.readouterr()
        got_mu, got_sigma = reader(path, None, resize_mode="clean")
        assert np.array_equal(got_mu, mu) and np.array_equal(got_sigma, sigma)
        assert "warning" not in capsys.readouterr().out
        reader(path, None, resize_mode="torch")
        assert "resize_mode=clean but this run uses torch" in capsys.readouterr().out


def _write_folder(root, imgs):
    os.makedirs(root, exist_ok=True)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(os.path.join(root, f"{i:03d}.png"))
    return root


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def _check_ssim_curve_and_cost_quality(tmp_path, monkeypatch):
    """``tools/ssim_curve`` on a prune_ssim-shaped folder (stage_base and
    stages 1, 10, 100 of 4 noise PNGs each): its SSIM and MSE per stage lie
    within 1e-6 of JAX's ``pairwise_ssim_mse`` (noise images: no flat
    regions, where the two sum orders part by ~1e-6), the stages in order,
    the JSON and the PNG written. ``tools/cost_quality --smoke`` makes the
    JAX driver's (CLI, argv) sequence (``tests/_torch_drivers.py``)."""
    import _torch_drivers as D

    from diff_pruning_tpu_torch.tools import ssim_curve

    rng = np.random.default_rng(23)
    save = tmp_path / "curve"
    base = rng.integers(0, 256, (4, 24, 24, 3), dtype=np.uint8)
    for stage, amp in (("base", 0), (1, 60), (10, 30), (100, 10)):
        d = save / f"stage_{stage}"
        d.mkdir(parents=True)
        noisy = np.clip(base + rng.integers(-amp, amp + 1, base.shape), 0, 255)
        for i, img in enumerate(noisy.astype(np.uint8)):
            Image.fromarray(img).save(d / f"{i:06d}.png")
    table = ssim_curve.main([str(save), "--device", "cpu"])
    assert table["stages"] == [1, 10, 100]
    for n, s, m in zip(table["stages"], table["ssim"], table["mse"]):
        js, jm = jssim.pairwise_ssim_mse(str(save / "stage_base"), str(save / f"stage_{n}"))
        assert abs(s - js) <= 1e-6 and abs(m - jm) <= 1e-6, (n, s, js, m, jm)
    assert json.loads((save / "ssim_curve.json").read_text()) == table
    assert Image.open(save / "ssim_curve.png").size == (750, 480)

    fr = tmp_path / "fullrun"
    D.fake_fullrun_base(str(fr), 256)
    runs = {port: D.cost_quality_calls(monkeypatch, fr, tmp_path / f"cq_{port}",
                                       tmp_path / "cq_logs", port) for port in (False, True)}
    want, got = (D.normalised(runs[p], tmp_path / "cq_False", tmp_path / "cq_True")
                 for p in (False, True))
    assert got == want and len(want) == 14, (got, want)


def test_eval_clis_on_cpu(tmp_path, monkeypatch):
    """The procedural copy equals JAX's bit for bit (arrays and PNG bytes);
    ``get_dataset`` on a PNG folder gives JAX's arrays at the 256 default;
    fid_score (``--save-stats``, FID against the stats, then both again with
    ``--clean``) and fidelity on ``--device cpu`` give the JAX CLIs'
    numbers: mu to 1e-5 relative in norm (as the features); sigma to 1e-3
    (the random init's features share an offset ~300x their spread across
    images, RMS ~80 against ~0.26 centred, so their ~3e-7 relative error is
    ~1e-4 of the centred values that make the covariance); FID to 1e-4
    relative (8 images make covariances of rank 7 in 2048
    dimensions, and the square roots of the ~2040 eigenvalues that are zero
    in exact arithmetic add float64 noise of ~1e-5 relative on each side);
    ISC to 1e-5; KID to 1e-5 of the mean kernel value (the random init's
    features are ~80 in RMS, so the cubic kernel is ~1e11 and KID is an f32
    cancellation on both sides; features 3e-7 apart move each kernel value
    by ~1e-6 relative); precision/recall equal; compute_ssim prints
    the JAX CLI's SSIM and MSE lines. fid_score (``--save-stats``) and
    fidelity with ``--multihost`` over 2 gloo ranks, at batches of 3 (3, 3,
    2 images: each rank's rows padded, the last batch 1 + 1 rows), against
    one process at batches of 8: mu within 1e-5 relative in norm, sigma
    within 1e-3 (the features' offset again: batches of 2 and 8 move the
    features by ~5e-8 relative, sigma by ~3e-5), FID, IS, KID and
    precision/recall within 1e-5 relative (the printed 5 decimals at least),
    only rank 0 writing and printing. ``--device cuda`` raises
    where no GPU is present, and the CLIs leave TF32 off. ssim_curve gives
    JAX's SSIM per stage and cost_quality the JAX driver's CLI calls
    (``_check_ssim_curve_and_cost_quality``)."""
    from diff_pruning_tpu.cli import compute_ssim as jssim_cli
    from diff_pruning_tpu.cli import fid_score as jfid_cli
    from diff_pruning_tpu.cli import fidelity as jfidelity_cli
    from diff_pruning_tpu.data import datasets as jdata
    from diff_pruning_tpu.data import procedural as jproc
    from diff_pruning_tpu.utils import compile_cache
    from diff_pruning_tpu_torch.cli import compute_ssim, fid_score, fidelity
    from diff_pruning_tpu_torch.data import datasets as tdata
    from diff_pruning_tpu_torch.data import procedural as tproc

    # the JAX CLIs would point this process's JAX at an on-disk compile cache
    monkeypatch.setattr(compile_cache, "enable_persistent_compilation_cache",
                        lambda *a, **k: None)
    a = tproc.make_procedural_dataset(n=8, hw=32, seed=0)
    assert np.array_equal(a, jproc.make_procedural_dataset(n=8, hw=32, seed=0))
    b = tproc.make_procedural_dataset(n=8, hw=32, seed=1)
    imgs, labels = tproc.make_procedural_class_dataset(n_per_class=2, hw=16, n_classes=4,
                                                       seed=2)
    jimgs, jlabels = jproc.make_procedural_class_dataset(n_per_class=2, hw=16, n_classes=4,
                                                         seed=2)
    assert np.array_equal(imgs, jimgs) and np.array_equal(labels, jlabels)
    assert np.array_equal(tproc.class_palette(8), jproc.class_palette(8))
    assert np.array_equal(tproc.classify_by_palette(imgs, 4),
                          jproc.classify_by_palette(imgs, 4))
    tproc.write_labeled_folder(imgs, labels, str(tmp_path / "lab_t"))
    jproc.write_labeled_folder(imgs, labels, str(tmp_path / "lab_j"))
    files = tdata.list_image_files(str(tmp_path / "lab_t"))
    assert len(files) == 8
    for f in files:
        with open(f, "rb") as ft, open(f.replace("lab_t", "lab_j"), "rb") as fj:
            assert ft.read() == fj.read(), f

    da = _write_folder(str(tmp_path / "a"), a)
    db = _write_folder(str(tmp_path / "b"), b)
    for res in (None, 48):
        ds, jds = tdata.get_dataset(da, resolution=res), jdata.get_dataset(da, resolution=res)
        assert isinstance(ds, tdata.ImageFolderDataset) and len(ds) == len(jds) == 8
        for i in range(8):
            img = ds.load(i)
            assert img.shape == (res or 256,) * 2 + (3,)
            assert np.array_equal(img, jds.load(i))
    # a training batch of the folder (here resized to 48): the native loader's
    # decodes and bilinear resize, as the JAX package's iterate_batches with
    # its native library, shuffled and flipped by the draws of default_rng(seed)
    np.testing.assert_array_equal(next(tdata.iterate_batches(ds, 4)),
                                  next(jdata.iterate_batches(jds, 4)))

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    common = ["--random-init-seed", "0", "--batch-size", "8"]
    fids = {}
    for mode in ([], ["--clean"]):
        stats = {}
        for pkg, main, extra in (("jax", jfid_cli.main, []),
                                 ("torch", fid_score.main, ["--device", "cpu"])):
            stats[pkg] = str(tmp_path / f"{pkg}{len(mode)}.npz")
            with jax.default_matmul_precision("float32"):
                _, out = _run(main, [da, stats[pkg], "--save-stats"] + common + mode + extra)
                assert "NOTE: random-init inception (seed=0)" in out
                _, out = _run(main, [db, stats[pkg]] + common + mode + extra)
            assert "warning" not in out
            fids[pkg] = float(out.split("FID: ")[1].split()[0])
        with np.load(stats["jax"]) as zj, np.load(stats["torch"]) as zt:
            assert str(zt["resize_mode"]) == str(zj["resize_mode"]) == ("clean" if mode
                                                                        else "torch")
            assert _rel(zt["mu"], zj["mu"]) <= FEATURE_RTOL, mode
            assert _rel(zt["sigma"], zj["sigma"]) <= 1e-3, mode
        assert fids["torch"] == pytest.approx(fids["jax"], rel=1e-4), (mode, fids)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32

    weights = str(tmp_path / "w.pth")
    torch.save({**tinc.random_init_fid_inception_state_dict(0), **_fc_head(3)}, weights)
    argv = ["--input1", da, "--input2", db, "--weights", weights, "--batch_size", "8"]
    with jax.default_matmul_precision("float32"):
        want, _ = _run(jfidelity_cli.main, argv)
    got, out = _run(fidelity.main, argv + ["--device", "cpu"])
    assert json.loads(out.strip().splitlines()[-1]) == {k: round(v, 5) for k, v in got.items()}
    assert set(got) == set(want)
    feats = tfid.features_of_path(da, tinc.fid_inception(
        tinc.random_init_fid_inception_state_dict(0)), batch_size=8)
    scale = float(np.mean((feats.astype(np.float64) @ feats.T / 2048 + 1.0) ** 3))
    assert got["frechet_inception_distance"] == pytest.approx(
        want["frechet_inception_distance"], rel=1e-4)
    for key in ("inception_score_mean", "inception_score_std"):
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6), key
    for key in ("kernel_inception_distance_mean", "kernel_inception_distance_std"):
        assert abs(got[key] - want[key]) <= 1e-5 * scale, (key, got[key], want[key])
    assert got["precision"] == want["precision"] and got["recall"] == want["recall"]

    # --multihost: 2 gloo ranks, each running its rows of every batch of 3
    import _torch_dp

    stats2 = str(tmp_path / "torch_2ranks.npz")
    outs = _torch_dp.cli_ranks("fid_score", [da, stats2, "--save-stats", "--inception-weights",
                                             weights, "--batch-size", "3"])
    assert [("saved stats" in o) for o in outs] == [True, False]
    with np.load(str(tmp_path / "torch0.npz")) as z1, np.load(stats2) as z2:
        assert _rel(z2["mu"], z1["mu"]) <= FEATURE_RTOL and _rel(z2["sigma"], z1["sigma"]) <= 1e-3
    outs = _torch_dp.cli_ranks("fidelity", argv[:-1] + ["3"])
    assert not outs[1].strip().splitlines()[-1].startswith("{")
    two = json.loads(outs[0].strip().splitlines()[-1])
    assert set(two) == set(got)
    for key, v in two.items():  # KID: to 1e-5 of the mean kernel value, as above
        tol = 1e-5 * (scale if key.startswith("kernel") else abs(got[key]))
        assert abs(v - got[key]) <= max(tol, 5e-6), (key, v, got[key])

    want = _run(jssim_cli.main, [da, db, "--batch-size", "3"])[1].splitlines()
    got, out = _run(compute_ssim.main, [da, db, "--batch-size", "3", "--device", "cpu"])
    lines = out.splitlines()[-2:]
    assert [ln.split()[0] for ln in lines] == [ln.split()[0] for ln in want] == ["SSIM:",
                                                                               "MSE:"]
    assert lines == [f"SSIM: {got['ssim']:.6f}", f"MSE: {got['mse']:.6f}"]
    # SSIM's variances are differences of nearly equal f32 filter outputs
    # (these images have flat regions), so the two sum orders may part by
    # ~1e-6; the MSE is one f32 mean a side; both as printed (6 decimals)
    for ln, w, tol in zip(lines, want, (1e-5, 1e-6)):
        assert abs(float(ln.split()[1]) - float(w.split()[1])) <= tol, (lines, want)

    for main, args in ((fid_score.main, [da, db, "--random-init-seed", "0"]),
                       (fidelity.main, ["--input1", da, "--input2", db, "--weights", weights]),
                       (compute_ssim.main, [da, db])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args + ["--device", "cuda"])

    # the recipe drivers that score: ssim_curve and cost_quality
    _check_ssim_curve_and_cost_quality(tmp_path, monkeypatch)
