"""The f32-mode attention kernels' arithmetic (three-pass TF32), on the CPU.

``csrc/attention.cu`` runs the f32 mode (``attn_bf16`` off) on the tensor
cores: every operand is split into ``big = tf32(x)`` and ``small = tf32(x -
big)``, rounded to nearest, and every product ``A B`` is ``As Bb + Ab Bs +
Ab Bb``.  The kernels run only on the card, so their arithmetic is held here
through its plain-torch emulation (``attention_tf32_plain``,
``attention_bwd_tf32_plain``) against the JAX package's Pallas kernels in
interpret mode with ``bf16=False``, at the tolerances the card tests hold the
kernels to: forward max and mean absolute 1e-5, backward 1e-5 of each
gradient's largest value.  One TF32 product (``passes=1``) must miss them.
Inputs are seeded numpy at ragged sizes, q pre-scaled by 0.5 sqrt(32 / D)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nerfmatch_tpu.ops.pallas.attention_kernel import _fused_bwd, _fused_fwd

from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
    attention_bwd_tf32_plain, attention_tf32_plain, tf32_round, tf32_split,
    tf32_workspace_floats)

torch.set_num_threads(2)

# (B, L, S, H): S ragged against the 64-key tile, and below one tile.
SHAPES = [(2, 80, 200, 2), (1, 40, 20, 2)]
# One head_dim running zero-filled at 16, one whose rows are no multiple
# of 8 (zero-filled to 64 on the card), the widest.
HEAD_DIMS = [8, 33, 128]
TOL = 1e-5


def inputs(shape, d, seed=0):
    B, L, S, H = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32))
    return (mk(B, L, H, d, sc=0.5 * (32 / d) ** 0.5), mk(B, S, H, d),
            mk(B, S, H, d), mk(B, L, H, d))


def jax_forward(q, k, v):
    return torch.from_numpy(np.array(_fused_fwd(
        *map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), block_l=16,
        interpret=True, bf16=False)))


def jax_backward(q, k, v, g):
    grads = _fused_bwd(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy(),
                                          g.numpy())),
                       block_l=16, interpret=True, bf16=False)
    return [torch.from_numpy(np.array(r)) for r in grads]


def scaled(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def test_tf32_round_is_round_to_nearest():
    """The bit-masking rounding equals rounding the significand to 11 bits
    (10 fraction bits), ties away from zero, on random values, exact ties
    and values just below a power of two; it clears the low 13 bits."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.integers(-8, 8, size=4000),
        (1 + (2 * np.arange(50) + 1) * 2.0 ** -11) * 3.0,     # ties
        -(1 + (2 * np.arange(50) + 1) * 2.0 ** -11),
        np.nextafter(np.float32(2.0 ** np.arange(-20, 20)), np.float32(0)),
    ]).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    want = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) * 2.0 ** (e - 11)
    got = tf32_round(torch.from_numpy(x))
    assert np.array_equal(got.numpy().astype(np.float64), want)
    assert int((got.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_tf32_split_keeps_about_22_bits():
    """big + small, both TF32 values, is within 2^-22 of x relative, and
    the product of two splits without the small-small term within 2^-20."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=20000).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=20000).astype(np.float32))
    (xb, xs), (yb, ys) = tf32_split(x), tf32_split(y)
    for t in (xb, xs):
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    x64, y64 = x.double(), y.double()
    assert float(((xb.double() + xs.double() - x64).abs() / x64.abs()).max()) \
        <= 2.0 ** -22
    three = xs.double() * yb.double() + xb.double() * ys.double() \
        + xb.double() * yb.double()
    assert float(((three - x64 * y64).abs() / (x64 * y64).abs()).max()) \
        <= 2.0 ** -20


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tf32_forward_matches_pallas(shape, d):
    """The forward's three-pass TF32 arithmetic against
    ``_fused_fwd(interpret, bf16=False)``: max and mean absolute within
    1e-5; its ``lse`` within 1e-5 of ``torch.logsumexp`` in f64."""
    q, k, v, _ = inputs(shape, d)
    B, L, S, H = shape
    out, lse = attention_tf32_plain(q, k, v)
    err = (out - jax_forward(q, k, v)).abs()
    assert float(err.max()) < TOL and float(err.mean()) < TOL
    want = torch.logsumexp(torch.einsum("blhd,bshd->bhls", q.double(),
                                        k.double()), -1).reshape(B * H, L)
    assert float((lse.double() - want).abs().max()) < TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tf32_backward_matches_pallas(shape, d):
    """The backward's three-pass TF32 arithmetic, on the emulated
    forward's ``out`` and ``lse`` as the kernels take them, against
    ``_fused_bwd(interpret, bf16=False)``: dq, dk, dv each within 1e-5 of
    its largest value."""
    q, k, v, g = inputs(shape, d)
    out, lse = attention_tf32_plain(q, k, v)
    got = attention_bwd_tf32_plain(q, k, v, g, out, lse)
    for a, r in zip(got, jax_backward(q, k, v, g)):
        assert a.shape == r.shape
        assert scaled(a, r) < TOL


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_one_tf32_pass_misses_the_tolerance(d):
    """One TF32 product of the rounded operands (what a single-pass kernel
    would compute) misses both tolerances on the same inputs, by more than
    ten times: the card tests refuse such a kernel."""
    q, k, v, g = inputs(SHAPES[0], d)
    out, lse = attention_tf32_plain(q, k, v, passes=1)
    assert float((out - jax_forward(q, k, v)).abs().max()) > 10 * TOL
    got = attention_bwd_tf32_plain(q, k, v, g, out, lse, passes=1)
    assert max(scaled(a, r) for a, r in zip(got, jax_backward(q, k, v, g))) \
        > 10 * TOL


def test_tf32_workspace_floats():
    """The f32 mode's images: rows padded to 64, columns to the kernel
    width, big and small; the forward 2 (Lp + 2 Sp) rows of them a head,
    the backward 8 Lp + 6 Sp."""
    assert tf32_workspace_floats(2, 100, 129, 2, 33, False) == \
        2 * 2 * 64 * (2 * 128 + 4 * 192)
    assert tf32_workspace_floats(2, 100, 129, 2, 33, True) == \
        2 * 2 * 64 * (8 * 128 + 6 * 192)
    assert tf32_workspace_floats(1, 3600, 3600, 8, 32, True) == \
        8 * 32 * 14 * 3648
