"""Port parity of the attention kernels' algorithms, on the CPU.

``csrc/attention.cu`` runs only on the card, so what it computes is held
here through plain-torch versions of its two algorithms: the one-pass
forward with an integer power-of-two reference
(``attention_onepass_plain``) and the backward from the forward's row
statistic (``attention_bwd_stats_plain``), against the port's plain versions
and against the JAX package's Pallas kernels in interpret mode.  Inputs are
seeded numpy at ragged sizes around the kernels' 64-key tile; tolerances
per test.  The head_dims cover the kernels' instantiations (16, 32, 64,
128) and widths that run zero-filled at the next one (8, 48), with q
pre-scaled by 0.5 sqrt(32 / D), as the callers scale it by 1 / sqrt(D)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nerfmatch_tpu.ops.pallas.attention_kernel import _fused_bwd, _fused_fwd

from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
    KEY_TILE, MAX_HEAD_DIM, attention_bwd, attention_bwd_plain,
    attention_bwd_stats_plain, attention_onepass_plain, attention_plain,
    fused_attention_available, kernel_head_dim, operand_width)

torch.set_num_threads(2)

# (B, L, S, H): S ragged against the 64-key tile, below one tile, one past
# a tile boundary.
SHAPES = [(2, 80, 200, 2), (1, 40, 20, 2), (2, 33, 129, 1)]
D = 32
HEAD_DIMS = [8, 16, 32, 48, 64, 128]


def inputs(shape, seed=0, q_scale=0.5, d=D):
    B, L, S, H = shape
    D = d
    q_scale *= (32 / d) ** 0.5
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32))
    return (mk(B, L, H, D, sc=q_scale), mk(B, S, H, D), mk(B, S, H, D),
            mk(B, L, H, D))


def rnd(t):
    return t.to(torch.bfloat16).float()


def rounding_bound(q, k, v):
    """Elementwise bound on the distance between two bf16-mode attentions
    that round the unnormalized probabilities at different scales: each
    rounding is within 2^-8 relative (bf16 keeps 8 significant bits), so
    each output is within 2^-8 A of the attention with unrounded e, A the
    softmax-weighted mean of |v|, and two of them within 2^-7 A."""
    return 2.0 ** -7 * attention_plain(rnd(q), rnd(k), rnd(v).abs(), False)


def scaled(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def cosine(a, b):
    return float((a * b).sum()) / float(a.norm() * b.norm())


def logits(q, k, bf16):
    r = rnd if bf16 else (lambda t: t)
    return torch.einsum("blhd,bshd->bhls", r(q), r(k))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_onepass_rescales_are_exact(shape, bf16):
    """With the integer reference every rescale between tiles is a power of
    two, so the tiling changes nothing but the f32 summation order and the
    f32 rounding of ``x - r`` under another ``r``: tiles of 64, 16 and one
    tile for all keys agree to 2e-6 in f32 (outputs are O(1)) and to 2e-5
    in bf16 mode, where that last bit breaks a few bf16 rounding ties of
    the probabilities apart."""
    q, k, v, _ = inputs(shape)
    ref, lse_ref = attention_onepass_plain(q, k, v, bf16, tile=k.shape[1])
    for tile in (KEY_TILE, 16):
        out, lse = attention_onepass_plain(q, k, v, bf16, tile=tile)
        assert float((out - ref).abs().max()) < (2e-5 if bf16 else 2e-6)
        assert float((lse - lse_ref).abs().max()) < 2e-6


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_onepass_f32_equals_plain_and_pallas(shape, d):
    """f32 mode: the one-pass algorithm equals ``attention_plain`` and
    ``_fused_fwd(interpret)`` to 1e-5 (other summation orders)."""
    q, k, v, _ = inputs(shape, d=d)
    out, _ = attention_onepass_plain(q, k, v, False)
    assert float((out - attention_plain(q, k, v)).abs().max()) < 1e-5
    ref = _fused_fwd(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                     block_l=16, interpret=True, bf16=False)
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_onepass_bf16_within_the_modes_rounding(shape, d):
    """bf16 mode: q, k, v and the unnormalized probabilities are rounded to
    bf16 where the JAX kernel rounds them, but the one-pass forward rounds
    ``2^(x - ceil(max x))`` and the two-pass kernels ``exp(s - max)``;
    their ratio is no power of two, so the two roundings fall
    independently.  Against ``attention_plain(bf16=True)`` and against
    ``_fused_fwd(interpret, bf16=True)`` every element stays within the
    bound of two such roundings (``rounding_bound``, + 1e-6 for the f32
    sums), and the mean difference within a quarter of the mean bound
    (the roundings are not all adverse)."""
    q, k, v, _ = inputs(shape, d=d)
    bound = rounding_bound(q, k, v)
    out, _ = attention_onepass_plain(q, k, v, True)
    jref = torch.from_numpy(np.array(_fused_fwd(
        *map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), block_l=16,
        interpret=True, bf16=True)))
    for ref in (attention_plain(q, k, v, True), jref):
        err = (out - ref).abs()
        assert bool((err <= bound + 1e-6).all())
        assert float(err.mean()) < float(bound.mean()) / 4


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_onepass_lse_is_logsumexp(shape, bf16):
    """``lse`` equals ``logsumexp`` of the logits to 1e-5, (B * H, L)."""
    q, k, v, _ = inputs(shape)
    B, L, S, H = shape
    _, lse = attention_onepass_plain(q, k, v, bf16)
    want = torch.logsumexp(logits(q, k, bf16), -1).reshape(B * H, L)
    assert lse.shape == (B * H, L)
    assert float((lse - want).abs().max()) < 1e-5


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bwd_from_stats_matches_plain_and_pallas(shape, bf16, d):
    """The backward's formulas (z from ``lse``, delta = rowsum(g * out),
    with ``out`` and ``lse`` from the one-pass forward in the same mode)
    against ``attention_bwd_plain`` and ``_fused_bwd(interpret)``.  f32:
    1e-5 of each gradient's largest value.  bf16 (bf16 q, k, v, g, z and dl
    on all sides; rounding ties of z and dl broken apart, and the forward's
    rounding of e reaching delta): 1e-2 of the largest value, cosine >
    0.999."""
    q, k, v, g = inputs(shape, d=d)
    out, lse = attention_onepass_plain(q, k, v, bf16)
    got = attention_bwd_stats_plain(q, k, v, g, out, lse, bf16)
    jref = _fused_bwd(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy(),
                                         g.numpy())),
                      block_l=16, interpret=True, bf16=bf16)
    jref = [torch.from_numpy(np.array(r)) for r in jref]
    for ref in (attention_bwd_plain(q, k, v, g, bf16), jref):
        for a, r in zip(got, ref):
            assert a.shape == r.shape
            assert scaled(a, r) < (1e-2 if bf16 else 1e-5)
            assert cosine(a, r) > 0.999


@pytest.mark.parametrize("bf16", [False, True])
def test_attention_bwd_with_and_without_stats_on_cpu(bf16):
    """On CPU tensors ``attention_bwd`` takes the plain backward, or the
    backward from the statistics when ``out`` and ``lse`` are handed in;
    the two agree (f32: 1e-5 of the largest value; bf16: 1e-2), and one
    without the other is refused."""
    q, k, v, g = inputs(SHAPES[0], seed=4)
    out, lse = attention_onepass_plain(q, k, v, bf16)
    alone = attention_bwd(q, k, v, g, bf16)
    given = attention_bwd(q, k, v, g, bf16, out=out, lse=lse)
    for a, r in zip(given, alone):
        assert scaled(a, r) < (1e-2 if bf16 else 1e-5)
    for a, r in zip(alone, attention_bwd_plain(q, k, v, g, bf16)):
        assert torch.equal(a, r)
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, g, bf16, out=out)
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, g, bf16, lse=lse)


def test_onepass_handles_a_first_tile_far_below_the_maximum():
    """A late key 80 above the rest forces a rescale by 2^-115 or so: the
    early tiles' share underflows to what the two-pass softmax gives them,
    and nothing overflows."""
    q, k, v, _ = inputs((1, 8, 200, 1), seed=7)
    q[:] = 0.0
    q[..., 0] = 1.0
    k[..., 0] = 0.0
    k[0, 150, 0, 0] = 80.0
    out, lse = attention_onepass_plain(q, k, v, False)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert float((out - attention_plain(q, k, v)).abs().max()) < 1e-5
    assert float((lse - 80.0).abs().max()) < 1e-4


def test_kernel_head_dim_and_operand_width():
    """The instantiated width a head_dim runs at on the card: 1-16 -> 16,
    17-32 -> 32, 33-64 -> 64, 65-128 -> 128; above 128 (the JAX gate's
    limit) NotImplementedError.  The bf16 operands' rows are D rounded up to
    8 columns (16 bytes), and the route predicate keeps the JAX gate's
    head_dim test."""
    for d in range(1, MAX_HEAD_DIM + 1):
        want = 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 128
        assert kernel_head_dim(d) == want, d
        assert operand_width(d) % 8 == 0 and d <= operand_width(d) < d + 8
        assert operand_width(d) <= kernel_head_dim(d)
    for d in (129, 256):
        with pytest.raises(NotImplementedError):
            kernel_head_dim(d)
    q, k = torch.zeros(1, 256, 1, 128), torch.zeros(1, 256, 1, 128)
    assert fused_attention_available(q, k)
    assert not fused_attention_available(torch.zeros(1, 256, 1, 129),
                                         torch.zeros(1, 256, 1, 129))


@pytest.mark.parametrize("cfeat_dim", [128, 512])
def test_coarse_matcher_at_wide_heads_matches_jax(cfeat_dim):
    """The Mini (coarse) matcher with image and point self-attention and a
    coarse cross layer at cfeat_dim 128 and 512 (8 heads of 16 and of 64)
    against the JAX matcher on exported weights: conf at 1e-4, identical
    matches."""
    import jax

    from nerfmatch_tpu.models.matcher_coarse import (
        CoarseMatcherConfig as JCoarseConfig, NeRFMatcherCoarse as JCoarse)
    from nerfmatch_tpu_torch.models.matcher_coarse import (
        CoarseMatcherConfig, NeRFMatcherCoarse)
    from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

    from test_torch_models import flat_params, rnd, t

    cfg = dict(backbone="tiny", cfeat_dim=cfeat_dim, pt_dim=64, im_sa=1,
               im_sa_type="full", pt_sa=1, coarse_layers=1, temp_type="div")
    jm = JCoarse(JCoarseConfig(**cfg))
    params = jm.init_params(jax.random.PRNGKey(3))
    img = rnd(30, 1, 64, 64, 3)
    feat, pts = rnd(31, 1, 64, 64), rnd(32, 1, 64, 3, scale=0.3)
    ref = jm.forward_match(params, jnp.asarray(img), jnp.asarray(feat),
                           jnp.asarray(pts), mutual=True)
    tm = NeRFMatcherCoarse(CoarseMatcherConfig(**cfg))
    tm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    assert {m.proj_q.out_features // m.head_num
            for m in tm.modules() if hasattr(m, "proj_q")} == {cfeat_dim // 8}
    with torch.no_grad():
        ours = tm.forward_match(t(img), t(feat), t(pts), mutual=True)
    np.testing.assert_allclose(ours["conf_matrix"].numpy(), ref["conf_matrix"],
                               atol=1e-4)
    v = np.asarray(ref["valid"])
    np.testing.assert_array_equal(ours["valid"].numpy(), v)
    np.testing.assert_array_equal(ours["j_ids"].numpy()[v],
                                  np.asarray(ref["j_ids"])[v])
