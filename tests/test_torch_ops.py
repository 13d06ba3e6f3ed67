"""The port's ops on the CPU: the plain versions of the kernels, forward and
backward, against the JAX layer math and the Pallas kernels (interpret
mode). (Import hygiene: tests/test_torch_pruning.py::test_port_imports_nothing_of_jax.)

On the CPU each op's wrapper must run its plain version and launch nothing;
the kernels themselves are compared with these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances (|port - jax| <= atol + rtol * |jax|):
- f32: 1e-5 + 1e-5 rel; the same f32 formulas, summed in another order.
- bf16: 1e-2 + 1.6e-2 rel (two bf16 ulps); both sides compute in f32 and
  round the result to bf16 once, so a sum-order change can flip one ulp.
- high-mean low-variance GN against a float64 reference: 5e-2, the bound
  the JAX package's own test holds its layer to.
- gradients (f32): 1e-4 + 1e-4 rel against the Pallas backward kernels.
  The GroupNorm one recomputes its statistics with E[x^2]-E[x]^2 where the
  port reads the forward's shifted ones, and both sum in other orders;
  against torch autograd of the plain forward, 2e-5 + 2e-5 rel (same
  statistics, another order of the same f32 sums).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diff_pruning_tpu.models.layers import GroupNorm as JaxGroupNorm, Scope as JaxScope
from diff_pruning_tpu.pruning.graph import ChannelGraph
from diff_pruning_tpu_torch import ops
from diff_pruning_tpu_torch.models.layers import GroupNorm, Scope
from diff_pruning_tpu_torch.ops.attention import flash_attention, reference_attention
from diff_pruning_tpu_torch.ops.group_norm import group_norm, group_norm_reference

torch.set_num_threads(2)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1.6e-2)}


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# (dtype, B, H, W, C, groups, silu): C/g = 12 and 3, in both variance paths
GN_CASES = [("float32", 2, 8, 8, 96, 8, True), ("float32", 2, 5, 7, 24, 8, False),
            ("bfloat16", 2, 8, 8, 96, 8, False), ("bfloat16", 2, 5, 7, 24, 8, True)]


@pytest.mark.parametrize("case", GN_CASES, ids=lambda c: f"{c[0]}-C{c[4]}-silu{c[6]}")
def test_group_norm_matches_jax_layer(case):
    dtype, b, h, w, c, g, silu = case
    rng = np.random.default_rng(0)
    x = (2.0 * rng.standard_normal((b, h, w, c)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jgn = JaxGroupNorm(JaxScope(ChannelGraph())("gn"), ChannelGraph().var("v", c), g)
    with jax.default_matmul_precision("float32"):
        want = jgn({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                   jnp.asarray(x).astype(dtype), with_silu=silu)

    layer = GroupNorm(Scope(ChannelGraph())("gn"), ChannelGraph().var("v", c), g,
                      device="cpu")
    with torch.no_grad():
        layer.scale.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xt = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    before = dict(ops.LAUNCHES)
    with torch.inference_mode():
        got = layer(xt, with_silu=silu).permute(0, 2, 3, 1)
        plain = group_norm_reference(xt.permute(0, 2, 3, 1), layer.scale, layer.bias,
                                     groups=g, with_silu=silu)
    assert ops.LAUNCHES == before  # the CPU wrapper launches nothing
    assert got.dtype == getattr(torch, dtype)
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    _close(got.float(), np.asarray(want, np.float32), dtype)


def test_group_norm_high_mean_low_variance():
    """mean 100, std 1e-2 (tests/test_pallas_ops.py): the f32 shifted
    variance tracks a float64 reference where E[x^2]-E[x]^2 would not."""
    rng = np.random.default_rng(0)
    x64 = (100.0 + 1e-2 * rng.standard_normal((2, 4, 4, 32))).astype(np.float32)
    x64 = x64.astype(np.float64)
    xg = x64.reshape(2, 4, 4, 8, 4)
    ref = ((xg - xg.mean(axis=(1, 2, 4), keepdims=True))
           / np.sqrt(xg.var(axis=(1, 2, 4), keepdims=True) + 1e-6)).reshape(x64.shape)
    y = group_norm(torch.from_numpy(x64).float(), torch.ones(32), torch.zeros(32), groups=8)
    np.testing.assert_allclose(y.numpy(), ref, atol=5e-2)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_pallas_kernel(silu):
    """Against the TPU kernel itself (interpret mode). It always uses the
    one-pass variance, so the input is zero-mean per channel, where the
    shifted and one-pass formulations agree to f32 rounding."""
    from diff_pruning_tpu.ops.group_norm import fused_group_norm

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    scale = (1.0 + 0.2 * rng.standard_normal(128)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = fused_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                groups=32, with_silu=silu, interpret=True)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                     groups=32, with_silu=silu)
    _close(got, np.asarray(want), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(dtype):
    """Plain attention against the JAX reference and (f32) the Pallas
    forward, at D = 56 with a kv length that is not a block multiple."""
    from diff_pruning_tpu.ops.attention import _flash_fwd_res
    from diff_pruning_tpu.ops.attention import reference_attention as jax_reference

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 2, 40, 56)).astype(np.float32)
    k = rng.standard_normal((2, 2, 70, 56)).astype(np.float32)
    v = rng.standard_normal((2, 2, 70, 56)).astype(np.float32)
    scale = 56 ** -0.5
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    with jax.default_matmul_precision("float32"):
        want = jax_reference(jq, jk, jv, scale)
        pallas = _flash_fwd_res(jq, jk, jv, scale, True, with_lse=False)[0]
    before = dict(ops.LAUNCHES)
    got = flash_attention(tq, tk, tv, scale)
    assert ops.LAUNCHES == before
    torch.testing.assert_close(got, reference_attention(tq, tk, tv, scale), atol=0, rtol=0)
    _close(got.float(), np.asarray(want, np.float32), dtype)
    if dtype == "float32":
        _close(got, np.asarray(pallas), dtype)


# (B, H, W, C, groups, silu): C/g = 4 without and with SiLU, and a ragged C/g of 5
GN_GRAD_CASES = [(2, 8, 8, 128, 32, False), (2, 8, 8, 128, 32, True), (2, 5, 7, 40, 8, True)]


def _gn_inputs(case, seed):
    b, h, w, c, g, silu = case
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((b, h * w, c)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wt = rng.standard_normal(x.shape).astype(np.float32)  # so dy is not constant
    return x, scale, bias, wt


def _port_grads(fn, arrays, wt, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts, **kw)
    (out * torch.from_numpy(wt)).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", GN_GRAD_CASES, ids=lambda c: f"C{c[3]}-g{c[4]}-silu{c[5]}")
def test_group_norm_backward_matches_pallas(case):
    """dx, dscale, dbias through the port's autograd Function (the plain
    backward on the CPU) against jax.grad of the Pallas kernel."""
    from diff_pruning_tpu.ops.group_norm import fused_group_norm

    *_, g, silu = case
    x, scale, bias, wt = _gn_inputs(case, seed=3)
    before = dict(ops.LAUNCHES)
    got = _port_grads(group_norm, (x, scale, bias), wt, groups=g, with_silu=silu)
    assert ops.LAUNCHES == before

    def f(x, s, b):
        return (fused_group_norm(x, s, b, groups=g, with_silu=silu, interpret=True) * wt).sum()

    with jax.default_matmul_precision("float32"):
        want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias))
    for a, b_, name in zip(got, want, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(a, np.asarray(b_), atol=1e-4, rtol=1e-4, err_msg=name)


def test_group_norm_backward_reference_matches_autograd():
    """group_norm_backward_reference against torch autograd of
    group_norm_reference, given the forward's statistics."""
    from diff_pruning_tpu_torch.ops.group_norm import (group_norm_backward_reference,
                                                        group_norm_stats_reference)

    for i, case in enumerate(GN_GRAD_CASES):
        *_, g, silu = case
        x, scale, bias, wt = _gn_inputs(case, seed=4 + i)
        want = _port_grads(group_norm_reference, (x, scale, bias), wt, groups=g, with_silu=silu)
        tx = torch.from_numpy(x)
        mean, rstd = group_norm_stats_reference(tx, g)
        assert mean.shape == rstd.shape == (x.shape[0], g) and mean.dtype == torch.float32
        got = group_norm_backward_reference(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                                            torch.from_numpy(wt), mean, rstd, groups=g,
                                            with_silu=silu)
        for a, b_, name in zip(got, want, ("dx", "dscale", "dbias")):
            np.testing.assert_allclose(a.numpy(), b_, atol=2e-5, rtol=2e-5,
                                       err_msg=f"{case} {name}")


@pytest.mark.parametrize("shapes", [[(2, 1, 64, 64, 32)], [(2, 2, 40, 70, 56)],
                                    [(2, 1, 48, 48, 384), (2, 1, 48, 1, 384),
                                     (2, 1, 48, 48, 384, "bfloat16"),
                                     (2, 1, 48, 1, 384, "bfloat16"),
                                     (2, 1, 48, 48, 268, "bfloat16"),
                                     (2, 1, 48, 1, 268, "bfloat16")]],
                         ids=["square", "ragged", "wide"])
def test_attention_backward_matches_pallas(shapes):
    """dq, dk, dv through the port's autograd Function (plain backward on the
    CPU) and the forward's lse, against the Pallas kernels (interpret mode):
    square, a ragged head dim with Nq != Nkv, and the LDM's wide head dim
    (D = 384, which the Pallas kernels pad to 128 lanes) with Nkv = Nq and
    Nkv = 1 (the class-token cross-attention, where dq and dk are zero in
    exact arithmetic and both sides hold only f32 noise, well inside atol);
    then in bf16, as the LDM train step runs them, at D = 384 and the pruned
    268, each with Nkv = Nq and 1. bf16 tolerance: |port - jax| <= 2e-2 x
    max|jax| per gradient (both compute in f32 from the same bf16 inputs and
    round each gradient to bf16 once, but each side's o, and so D =
    rowsum(dO * O), comes from its own bf16 forward), plus 1e-6 of the
    largest gradient for dq and dk at Nkv = 1."""
    for shape in shapes:
        _check_attention_backward(shape)


def _check_attention_backward(shape):
    from diff_pruning_tpu.ops.attention import _flash_fwd_res
    from diff_pruning_tpu.ops.attention import flash_attention as jax_flash
    from diff_pruning_tpu_torch.ops.attention import reference_attention_lse

    b, h, nq, nkv, d, *dtype = shape
    dtype = dtype[0] if dtype else "float32"
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, nkv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, nkv, d)).astype(np.float32)
    wt = rng.standard_normal(q.shape).astype(np.float32)
    scale = d ** -0.5
    before = dict(ops.LAUNCHES)
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_() for a in (q, k, v)]
    (flash_attention(*ts, scale) * torch.from_numpy(wt)).sum().backward()
    got = [t.grad.float().numpy() for t in ts]
    assert ops.LAUNCHES == before

    def f(q, k, v):
        return (jax_flash(q, k, v, scale, interpret=True, min_tokens=1) * wt).sum()

    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v))
    with jax.default_matmul_precision("float32"):
        want = [np.asarray(g, np.float32) for g in jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)]
        jlse = _flash_fwd_res(jq, jk, jv, scale, True, with_lse=True)[1][4]
    gmax = max(float(np.abs(w).max()) for w in want)
    for a, b_, name in zip(got, want, ("dq", "dk", "dv")):
        if dtype == "float32":
            np.testing.assert_allclose(a, b_, atol=1e-4, rtol=1e-4, err_msg=f"{name} {shape}")
        else:
            floor = 1e-6 * gmax if nkv == 1 and name != "dv" else 0.0
            err = float(np.abs(a - b_).max())
            assert err <= 2e-2 * float(np.abs(b_).max()) + floor, (name, shape, err)
    lse = reference_attention_lse(*(t.detach() for t in ts), scale)[1]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :nq, 0].reshape(b, h, nq),
                               atol=1e-5, rtol=1e-5, err_msg=str(shape))
