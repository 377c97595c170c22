"""Port parity: the plain versions of the fused StarReLU + depthwise conv
(kernels 7, 8, 9) and of the attention backward (kernel 4) against the JAX
Pallas kernels in interpret mode, and the CPU autograd of ``dw_star``
against ``jax.vjp`` of the JAX op.  Inputs are seeded numpy; tolerances
per test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.ops.pallas import sepconv_kernel as jsep
from nerfmatch_tpu.ops.pallas.attention_kernel import _fused_bwd

from nerfmatch_tpu_torch.models import backbone as tbb
from nerfmatch_tpu_torch.ops.kernels import sepconv_kernel as tsep
from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
    attention_bwd, attention_bwd_plain, fused_attention)

torch.set_num_threads(2)

SHAPES = [                 # tests/test_pallas_sepconv.py
    (2, 19, 13, 128, 7),
    (1, 8, 8, 256, 3),
    (2, 30, 16, 128, 7),
    # H and W not multiples of the CUDA kernels' 16 x 16 tile, W = K: the
    # padding-after-activation corners of a ragged tile.
    (2, 23, 7, 128, 7),
]


def inputs(B, H, W, C, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, W, C)).astype(np.float32),
            (rng.normal(size=(K, K, C)) * 0.2).astype(np.float32),
            rng.normal(size=(C,)).astype(np.float32),
            np.float32(0.8944), np.float32(-0.4472),
            np.random.default_rng(seed + 7).normal(size=(B, H, W, C)).astype(
                np.float32))


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_dw_star_plain_matches_pallas_kernels(shape):
    """Forward vs ``_dw_star_fwd``, dgrad vs ``_dw_star_dgrad`` and wgrad vs
    ``_dw_star_wgrad`` (interpret): atol/rtol 1e-5 for y and dx, 1e-4 for
    the sums dw, ds and db."""
    x, w, cb, s, b, g = inputs(*shape)
    K = shape[-1]
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    y = jsep._dw_star_fwd(jx, jw, jnp.asarray(cb), s, b, interpret=True)
    np.testing.assert_allclose(
        tsep.dw_star_plain(t(x), t(w), t(cb), t(s), t(b)).numpy(),
        np.asarray(y), atol=1e-5, rtol=1e-5)
    dx, ds, db = jsep._dw_star_dgrad(jx, jw, s, jg, interpret=True)
    pdx, pds, pdb = tsep.dw_star_dgrad_plain(t(x), t(w), t(s), t(g))
    np.testing.assert_allclose(pdx.numpy(), np.asarray(dx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose([float(pds), float(pdb)],
                               [float(ds), float(db)], atol=1e-4, rtol=1e-4)
    dw = jsep._dw_star_wgrad(jx, s, b, jg, K=K, interpret=True)
    np.testing.assert_allclose(
        tsep.dw_star_wgrad_plain(t(x), t(s), t(b), t(g), K=K).numpy(),
        np.asarray(dw), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 17, 9, 128, 7), (1, 16, 16, 256, 7),
                                   (2, 33, 20, 128, 7), (1, 7, 7, 128, 7)])
def test_dw_star_wgrad_plain_matches_pallas_wgrad(shape):
    """``dw_star_wgrad_plain`` vs ``_dw_star_wgrad`` (interpret), atol/rtol
    1e-4, at shapes whose image edges fall inside the CUDA kernel's 16 x 16
    tiles (ragged tiles, one tile, a tile larger than the image): the
    activated map is 0 outside the image, not StarReLU(0) = b."""
    x, _, _, s, b, g = inputs(*shape, seed=11)
    K = shape[-1]
    dw = jsep._dw_star_wgrad(jnp.asarray(x), s, b, jnp.asarray(g), K=K,
                             interpret=True)
    np.testing.assert_allclose(
        tsep.dw_star_wgrad_plain(t(x), t(s), t(b), t(g), K=K).numpy(),
        np.asarray(dw), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("wrapper", ["dw_star_fwd", "dw_star_dgrad",
                                     "dw_star_wgrad"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, monkeypatch):
    """A kernel wrapper handed CPU tensors raises ``ValueError`` before it
    builds or loads the kernels (a launch would take host pointers)."""
    def no_build():
        raise AssertionError("the kernels were built for CPU tensors")

    monkeypatch.setattr(tsep, "library", no_build)
    x, w, cb, s, b, g = (t(a) for a in inputs(1, 16, 16, 128, 7))
    calls = {"dw_star_fwd": lambda: tsep.dw_star_fwd(x, w, cb, s, b),
             "dw_star_dgrad": lambda: tsep.dw_star_dgrad(x, w, s, g),
             "dw_star_wgrad": lambda: tsep.dw_star_wgrad(x, s, b, g)}
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[wrapper]()


def test_dw_star_autograd_matches_jax_vjp():
    """All five cotangents of the port's ``dw_star`` on CPU (autograd of the
    plain version) vs ``jax.vjp`` of ``dw_star`` (the Pallas VJP, run
    through its XLA reference on CPU): atol/rtol 1e-4."""
    x, w, cb, s, b, g = inputs(2, 12, 10, 128, 7, seed=3)
    _, vjp = jax.vjp(jsep.dw_star_reference, *map(jnp.asarray,
                                                   (x, w, cb, s, b)))
    ref = vjp(jnp.asarray(g))
    ins = [t(a).requires_grad_() for a in (x, w, cb, s, b)]
    (tsep.dw_star(*ins) * t(g)).sum().backward()
    for got, want in zip(ins, ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_dw_star_gate_and_route_match_jax():
    """The port's gate is the JAX one minus its backend test (same row
    block search), and a SepConv on CPU equals StarReLU + conv2d."""
    for H in (240, 120, 60, 19, 7, 37):
        assert tsep._row_block(H, 7) == jsep._row_block(H, 7)
    assert tsep.dw_star_available(torch.zeros(2, 60, 60, 512),
                                  torch.zeros(7, 7, 512))
    assert not tsep.dw_star_available(torch.zeros(1, 8, 8, 96),
                                      torch.zeros(7, 7, 96))
    assert not tsep.dw_star_available(torch.zeros(1, 37, 8, 128),
                                      torch.zeros(7, 7, 128))
    torch.manual_seed(0)
    sep = tbb.SepConv(64, 2)
    x = torch.randn(1, 9, 9, 64)
    h = sep.pwconv1(x)
    want = sep.pwconv2(tsep.dw_star_plain(
        h, sep.dwconv.weight[:, 0].permute(1, 2, 0), sep.dwconv.bias,
        sep.act1.scale, sep.act1.bias))
    torch.testing.assert_close(sep(x), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_attention_bwd_plain_matches_pallas_bwd(bf16):
    """``attention_bwd_plain`` vs ``_fused_bwd(block_l=16, interpret)`` at
    tests/test_matchers.py's shapes.  f32: atol 2e-5.  bf16 mode (bf16 q,
    k, v, g, z and dl on both sides; a few bf16 rounding ties of z and dl
    break apart under other summation orders): max 2e-3 of each output's
    largest value, mean 1e-5."""
    rng = np.random.default_rng(3)
    B, L, S, H, D = 2, 40, 72, 4, 32
    q = (rng.normal(size=(B, L, H, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, S, H, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, S, H, D)).astype(np.float32)
    g = rng.normal(size=(B, L, H, D)).astype(np.float32)
    ref = _fused_bwd(*map(jnp.asarray, (q, k, v, g)), block_l=16,
                     interpret=True, bf16=bf16)
    got = attention_bwd(t(q), t(k), t(v), t(g), bf16)
    for a, r in zip(got, ref):
        err = np.abs(a.numpy() - np.asarray(r))
        if bf16:
            assert err.max() < 2e-3 * np.abs(r).max() and err.mean() < 1e-5, \
                (err.max(), err.mean())
        else:
            assert err.max() < 2e-5, err.max()


def test_fused_attention_cpu_autograd_is_the_plain_backward():
    """On CPU tensors ``fused_attention`` runs the plain forward and
    autograd through it; its gradients equal ``attention_bwd_plain``."""
    rng = np.random.default_rng(5)
    q, k, v, g = (t(rng.normal(size=(1, 20, 2, 32)) * 0.5) for _ in range(4))
    qq, kk, vv = (a.clone().requires_grad_() for a in (q, k, v))
    (fused_attention(qq, kk, vv) * g).sum().backward()
    for got, want in zip((qq.grad, kk.grad, vv.grad),
                         attention_bwd_plain(q, k, v, g)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
