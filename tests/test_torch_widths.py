"""Port parity: the render and train stages at every MLP width and encoding
width the JAX render kernels take, on the CPU.

On the card the render kernels (1, 1b, 5, 6) are instantiated at MLP widths
64, 128, 192, 256 and 512 (512 on engines of their own), the eval kernels
(1, 1b) also at 1024; any other width up to the family's largest runs at
the next wider one on a zero-padded copy of the weights
(``pad_mlp_to_kernel_width``), and wider ones raise.  The encodings go to the
JAX kernels' limits, 2 * 3 * F <= 128 and the view-direction PE plus the
appearance row <= 128.  Here:

* the padding is exact: the plain stages on the padded weights give the
  unpadded MLP's outputs, and the padded gradients sliced back its
  gradients;
* the plain eval stage at hid 96, 128, 320, 512, 640 and 1024, the train
  stage at 96-512, and both at F = 21, Fd = 18 with an appearance table,
  against
  the JAX fused kernels in interpret mode (``make_fused_render``,
  ``make_fused_train_render``);
* the int8 trunk packed at the kernel's width keeps the real columns of the
  unpadded pack byte for byte, its padded columns at unit scale, and at 512
  and 1024 its s8 images keep their K rows in order and hold the JAX
  quantizer's weights;
* the sizes the C side is handed agree at the padded widths; a stage's
  kernel weights padded once are the bytes of padding twice;
* the check functions accept what the JAX kernels take and raise
  ``NotImplementedError`` naming the ROADMAP above 1024 (eval) and 512
  (train), without a launch;
  the trainer routes a NeRF the train kernels do not hold to the plain
  path, by its config alone.

Inputs are seeded numpy arrays; the weights cross through the weight
bridge.  Tolerances are stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.nerf.embedding import pe_embedding as j_pe
from nerfmatch_tpu.nerf.model import NerfConfig as JNerfConfig
from nerfmatch_tpu.nerf.model import init_nerf_params
from nerfmatch_tpu.ops.pallas.render_kernel import (FusedRenderSpec,
                                                    make_fused_render,
                                                    prepare_ray_inputs)
from nerfmatch_tpu.ops.pallas.render_train import (make_fused_train_render,
                                                   pack_mlp_weights_traced)

from nerfmatch_tpu_torch.nerf.model import NerfConfig, NerfMLP
from nerfmatch_tpu_torch.ops.kernels import quant
from nerfmatch_tpu_torch.ops.kernels import render_kernel as rk
from nerfmatch_tpu_torch.ops.kernels import render_train_kernel as rtk
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from _cpu import warm_up_vector_math
from test_torch_nerf import flat_params, unslot_s8
from test_torch_quant import unpack_images
from test_torch_train import _compare, _grads_by_jax_leaf, stage_loss

torch.set_num_threads(2)
# No compared computation below is a thread's first call of a vectorized
# transcendental (tests/_cpu.py).
warm_up_vector_math()

LAYERS, SKIPS, TAP = 4, (2,), 1
N = 8


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def make_mlp(hid, F=15, Fd=4, app=0, seed=0):
    """(JAX params, the port's MLP with the same weights) of a 4-layer mip
    NeRF with viewdirs, the descriptor tapped at layer 1, density bias +1
    (partly opaque)."""
    kw = dict(layer_num=LAYERS, hid_dim=hid, xyz_dim=6 * F, dirs_dim=6 * Fd + 3,
              app_dim=app, use_viewdirs=True, skips=SKIPS, stop_layer=TAP)
    params = init_nerf_params(jax.random.PRNGKey(seed), JNerfConfig(**kw))
    params["alpha_linear"]["bias"] = params["alpha_linear"]["bias"] + 1.0
    mlp = NerfMLP(NerfConfig(**kw))
    mlp.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return params, mlp


def make_inputs(S, seed, app=0):
    """(N, 12) unit-direction rays, jittered sorted fenceposts (N, S+1),
    density noise (N, S), a target (N, 3) and appearance rows (N, app)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (N, 3))
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((N, 1), 0.05), np.full((N, 1), 1.4),
                           d, np.full((N, 1), 0.002)], -1).astype(np.float32)
    u = np.sort(rng.uniform(0.0, 1.0, (N, S + 1)), axis=-1)
    u[:, 0], u[:, -1] = 0.0, 1.0
    z = (rays[:, 6:7] * (1.0 - u) + rays[:, 7:8] * u).astype(np.float32)
    noise = rng.normal(size=(N, S)).astype(np.float32)
    target = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    app_rows = (0.5 * rng.normal(size=(N, app))).astype(np.float32)
    return rays, z, noise, target, app_rows


# ---------------------------------------------------------------------------
# (a) the padding is exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hid,width", [(32, 64), (96, 128), (160, 192),
                                       (320, 512), (512, 512), (640, 1024)])
def test_pad_mlp_to_kernel_width_renders_the_same(hid, width):
    """The plain eval stage (coarse and fine) on the padded weights gives
    the unpadded MLP's weights, depth, acc, rgb and pts and, sliced to hid,
    its descriptor, with an f32 MLP and with the bf16 operand roundings
    (``trunk_bf16``, the kernels' products): the padded descriptor columns
    are exactly 0, and the outputs agree within 1e-6 of each one's largest
    value.  Not bit for bit: the padded zeros are exact, but a longer K
    changes how the CPU BLAS blocks an f32 product, so its sums run in
    another order (measured: at most 4.3e-7 relative, 1-3 ulps).  The MLP's
    own forward in ``compute_dtype`` bf16 within bf16 rounding (2^-7 of
    each output's largest value).  The module's parameters keep their
    shapes.  The eval kernels' widths (512 is one, 320 runs at it; 640 runs
    at 1024)."""
    _, mlp = make_mlp(hid, seed=hid)
    shapes = {k: v.shape for k, v in mlp.named_parameters()}
    kmlp, real = rtk.pad_mlp_to_kernel_width(mlp, "eval")
    assert real == hid and kmlp.cfg.hid_dim == width
    assert {k: v.shape for k, v in mlp.named_parameters()} == shapes
    rays, z, *_ = make_inputs(32, 1)
    kw = dict(num_freqs=15, dirs_freqs=4)
    with torch.no_grad():
        for fine in (False, True):
            for bf16 in (False, True):
                ref = rk.render_stage_plain(mlp, t(rays), t(z), fine=fine,
                                            trunk_bf16=bf16, **kw)
                got = rk.render_stage_plain(kmlp, t(rays), t(z), fine=fine,
                                            trunk_bf16=bf16, **kw)
                if fine:
                    assert not got["feat"][:, hid:].any()
                    got["feat"] = got["feat"][:, :hid]
                for k in ref:
                    err = float((got[k] - ref[k]).abs().max())
                    assert err <= 1e-6 * float(ref[k].abs().max()), \
                        (fine, bf16, k, err)
        x = t(np.random.default_rng(2).normal(size=(N, 16, 90 + 27)))
        ref, ref_feat = mlp(x, dtype=torch.bfloat16)
        got, got_feat = kmlp(x, dtype=torch.bfloat16)
        for a, b in ((got, ref), (got_feat[..., :hid], ref_feat)):
            assert float((a - b).abs().max()) <= 2 ** -7 * float(b.abs().max())


@pytest.mark.parametrize("hid", [32, 96, 160, 320])
def test_padded_train_gradients_slice_back_to_the_real_ones(hid):
    """The train stage on the padded weights, through mse(rgb) + 0.1
    mean(w^2): the f32 stage's autograd VJP (``train_stage_forward(bf16=
    False)``), sliced back (``unpad_grads``), within 1e-6 of the unpadded
    VJP's largest value, leaf by leaf; the explicit backward with the
    kernels' roundings (``render_train_plain``) within 2^-8, a bf16 step,
    of the leaf's largest value (it rounds its operands and the matrix
    gradients to bf16, and f32 sums in another order, as in the test above,
    may round an operand the other way, which moves the elements after it:
    measured at most 7.4e-4).  Rgb and weights within 1e-6; the padded rows
    and columns get no gradient at all."""
    _, mlp = make_mlp(hid, seed=hid + 1)
    kmlp, _ = rtk.pad_mlp_to_kernel_width(mlp, "train")
    rays, z, noise, target, _ = make_inputs(32, 3)
    for bf16, rel in ((False, None), (True, 2.0 ** -8)):
        grads, outs = [], []
        for m in (mlp, kmlp):
            m.zero_grad()
            spec = rtk.StageSpec(m, 15, 4)
            args = (spec, t(rays), t(z), t(noise))
            rgb, w = (rtk.render_train_plain(*args) if bf16
                      else rtk.train_stage_forward(*args, bf16=False))
            stage_loss(rgb, w, t(target), torch).backward()
            outs.append((rgb.detach(), w.detach()))
            grads.append({k: p.grad for k, p in m.named_parameters()})
        for a, b in zip(outs[1], outs[0]):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
        sliced = rtk.unpad_grads(grads[1], mlp)
        for k, ref in grads[0].items():
            got = sliced[k]
            assert got.shape == ref.shape, k
            err = (got - ref).abs()
            if rel is None:
                assert float(err.max()) <= 1e-6 * float(ref.abs().max()), k
            else:
                assert float(err.max()) <= rel * float(ref.abs().max()), k
            rest = grads[1][k].clone()
            if k == "views_linears.0.weight":
                rest[:ref.shape[0], :hid] = 0
                rest[:ref.shape[0], rest.shape[1] - (ref.shape[1] - hid):] = 0
            else:
                rest[tuple(slice(0, n) for n in ref.shape)] = 0
            assert not rest.any(), k


# ---------------------------------------------------------------------------
# (b) the plain stages against the JAX fused kernels at hid 96-512
# ---------------------------------------------------------------------------

def jax_eval_stage(params, hid, S, F=15, Fd=4, app=0):
    spec = FusedRenderSpec(num_freqs=F, hid_dim=hid, layer_num=LAYERS,
                           skips=SKIPS, samples=S, ray_tile=N, feat_layer=TAP,
                           from_rays=True, dirs_freqs=Fd, app_dim=app)
    return make_fused_render(spec, interpret=True), pack_mlp_weights_traced(
        params, spec)


def hold_eval(ours, ref):
    """The bf16 eval stage against the Pallas one: weights, depth and acc
    within 2e-3, rgb and pts within 2e-2 (the stage tolerances of
    test_torch_render_feat_max.py and test_torch_nerf.py: the Pallas
    encoding's fast sin and exp), the descriptor within 2e-2 of its largest
    value."""
    for k, tol in (("weights", 2e-3), ("depth", 2e-3), ("acc", 2e-3),
                   ("rgb", 2e-2), ("pts", 2e-2)):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=tol, err_msg=k)
    f = np.asarray(ref["feat"])
    rel = np.abs(ours["feat"].numpy() - f).max() / (np.abs(f).max() + 1e-9)
    assert rel < 2e-2, rel
    assert float(ours["weights"].sum(-1).max()) > 0.3   # not an empty field


@pytest.mark.parametrize("hid", [96, 128, 320, 512, 640, 1024])
def test_eval_stage_matches_pallas_at_width(hid):
    """The plain fine eval stage (bf16 products) against
    ``make_fused_render`` in interpret mode at hid 96 (run on the card at
    128, padded), 128, 320 (run at 512, padded), 512, 640 (run at 1024,
    padded) and 1024, 8 rays x 64
    samples (:func:`hold_eval`: weights, depth and acc within 2e-3, rgb and
    pts within 2e-2, the descriptor within 2e-2 of its largest value)."""
    params, mlp = make_mlp(hid, seed=7)
    rays, z, *_ = make_inputs(64, 5)
    fused, w = jax_eval_stage(params, hid, 64)
    ref = fused(w, jnp.asarray(rays), jnp.asarray(z))
    with torch.no_grad():
        ours = rk.render_stage_plain(mlp, t(rays), t(z), fine=True,
                                     num_freqs=15, dirs_freqs=4)
    hold_eval(ours, ref)


def jax_train_stage(params, hid, rays, z, noise, F=15, Fd=4, app=0):
    """The Pallas train stage (interpret) as a function of (params[, the
    appearance rows]): extras = [dirs PE | app | 0] to 128."""
    S = z.shape[1] - 1
    spec = FusedRenderSpec(num_freqs=F, hid_dim=hid, layer_num=LAYERS,
                           skips=SKIPS, samples=S, ray_tile=N, feat_layer=0)
    fused = make_fused_train_render(spec, interpret=True,
                                    extras_grad=app > 0)
    o8, d8 = prepare_ray_inputs(jnp.asarray(rays))
    dirs = j_pe(jnp.asarray(rays[:, 8:11]), Fd)

    def run(p, a=None):
        ex = dirs if a is None else jnp.concatenate([dirs, a], -1)
        extras = jnp.pad(ex, ((0, 0), (0, 128 - ex.shape[-1])))
        return fused(pack_mlp_weights_traced(p, spec), o8, d8,
                     jnp.asarray(z), extras, jnp.asarray(noise))
    return run


@pytest.mark.parametrize("hid", [96, 128, 320, 512])
def test_train_stage_matches_pallas_at_width(hid):
    """The plain train stage against ``make_fused_train_render`` in
    interpret mode at hid 96 (run on the card at 128, padded), 128, 320
    (run at 512, padded) and 512, 8 rays x 32 samples: rgb and weights
    within 2e-3, and through mse(rgb) + 0.1 mean(w^2) every leaf's gradient
    at cosine > 0.999 and norm ratio 1 +- 1e-2 (the tolerances of
    test_torch_train.py)."""
    params, mlp = make_mlp(hid, seed=9)
    rays, z, noise, target, _ = make_inputs(32, 6)
    run = jax_train_stage(params, hid, rays, z, noise)
    rgb_j, w_j = run(params)
    mlp.zero_grad()
    rgb, w = rtk.render_train_plain(rtk.StageSpec(mlp, 15, 4), t(rays), t(z),
                                    t(noise))
    np.testing.assert_allclose(rgb.detach().numpy(), rgb_j, atol=2e-3)
    np.testing.assert_allclose(w.detach().numpy(), w_j, atol=2e-3)
    stage_loss(rgb, w, t(target), torch).backward()
    g_j = jax.grad(lambda p: stage_loss(*run(p), jnp.asarray(target), jnp))(
        params)
    assert _compare(_grads_by_jax_leaf(mlp), flat_params(g_j), 0.999,
                    (0.99, 1.01), "pallas") >= 4 * LAYERS


# ---------------------------------------------------------------------------
# (e) the widest encodings
# ---------------------------------------------------------------------------

F_WIDE, FD_WIDE, APP = 21, 18, 16


def test_eval_stage_matches_pallas_at_the_widest_encoding():
    """F = 21 (126 encoding columns) and Fd = 18 with an appearance table
    (111 + 16 = 127 extras columns), hid 64: the plain fine eval stage
    against ``make_fused_render`` (from_rays, app_dim 16) in interpret mode
    (:func:`hold_eval`)."""
    params, mlp = make_mlp(64, F_WIDE, FD_WIDE, APP, seed=11)
    rays, z, _, _, app = make_inputs(64, 7, APP)
    fused, w = jax_eval_stage(params, 64, 64, F_WIDE, FD_WIDE, APP)
    ref = fused(w, jnp.asarray(rays), jnp.asarray(z), jnp.asarray(app))
    with torch.no_grad():
        ours = rk.render_stage_plain(mlp, t(rays), t(z), fine=True,
                                     num_freqs=F_WIDE, dirs_freqs=FD_WIDE,
                                     app=t(app))
    hold_eval(ours, ref)


def test_train_stage_matches_pallas_at_the_widest_encoding():
    """The same encoding in the plain train stage against
    ``make_fused_train_render(extras_grad=True)`` in interpret mode: rgb
    and weights within 2e-3, every weight leaf and ``g_app`` at cosine >
    0.999 and norm ratio 1 +- 1e-2 (test_torch_train_app.py's tolerances)."""
    params, mlp = make_mlp(64, F_WIDE, FD_WIDE, APP, seed=12)
    rays, z, noise, target, app = make_inputs(32, 8, APP)
    run = jax_train_stage(params, 64, rays, z, noise, F_WIDE, FD_WIDE, APP)
    rgb_j, w_j = run(params, jnp.asarray(app))
    mlp.zero_grad()
    a = t(app).requires_grad_(True)
    rgb, w = rtk.render_train_plain(rtk.StageSpec(mlp, F_WIDE, FD_WIDE),
                                    t(rays), t(z), t(noise), a)
    np.testing.assert_allclose(rgb.detach().numpy(), rgb_j, atol=2e-3)
    np.testing.assert_allclose(w.detach().numpy(), w_j, atol=2e-3)
    stage_loss(rgb, w, t(target), torch).backward()
    loss = lambda p, x: stage_loss(*run(p, x), jnp.asarray(target), jnp)
    g_j, g_aj = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(app))
    assert _compare(_grads_by_jax_leaf(mlp), flat_params(g_j), 0.999,
                    (0.99, 1.01), "pallas") >= 4 * LAYERS
    b = a.grad.numpy().ravel()
    g = np.asarray(g_aj).ravel()
    cos = g @ b / (np.linalg.norm(g) * np.linalg.norm(b))
    assert cos > 0.999 and abs(np.linalg.norm(b) / np.linalg.norm(g) - 1) \
        < 1e-2


# ---------------------------------------------------------------------------
# (c) the int8 trunk at the kernel's width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 2])
def test_kernel_int8_keeps_the_real_columns(start):
    """``pack_kernel_int8`` at hid 96 (run at 128): every int8 weight,
    unpacked from the kernel's s8 slot images, and every requant row equal
    byte for byte to ``pack_mlp_int8`` of the unpadded MLP on its real rows
    and columns; the padded weights zero, the padded columns at unit
    activation scale (qh and the bias rows B at 127 and 0.5, iq at 1 /
    127), every row finite."""
    hid, W = 96, 128
    _, mlp = make_mlp(hid, seed=13)
    rng = np.random.default_rng(14)
    scales = {"enc": t(rng.uniform(0.1, 1.0, 90)),
              "acts": [t(rng.uniform(0.5, 4.0, hid)) for _ in range(LAYERS)]}
    tap = TAP if start == 0 else None
    ref = quant.pack_mlp_int8(mlp, scales, start, tap)
    got = quant.pack_kernel_int8(mlp, scales, start, tap)
    ref_img, got_img = unpack_images(ref, LAYERS), unpack_images(got, LAYERS)
    assert set(got) == set(ref)
    for k, r in ref.items():
        if k in ("start", "tap"):
            assert got[k] == r
            continue
        if k == "img":
            continue
        g = got[k]
        assert torch.isfinite(g.float()).all(), k
        if k.startswith("w"):
            rows = r.shape[0] if k.endswith("sq") or k == "w0q" else hid
            for x in (g, got_img[k]):
                assert torch.equal(x[:rows, :hid], r[:rows, :hid]), k
                assert not x[:, hid:].any() and not x[rows:].any(), k
            assert torch.equal(ref_img[k], r)
        else:
            assert torch.equal(g[..., :r.shape[-1]], r), k
            pad = g[..., hid:]
            if k == "qh":
                assert torch.all(pad == 127.0), k
            elif k.startswith("B"):
                assert torch.all(pad == 0.5), k
            elif k.startswith("iq"):
                assert torch.all(pad == np.float32(1.0) / np.float32(127.0)), k
    assert quant.pack_kernel_int8(make_mlp(128, seed=15)[1], {
        "enc": scales["enc"], "acts": [t(np.ones(128))] * LAYERS}, start,
        tap)["w3q"].shape == (128, 128)


# ---------------------------------------------------------------------------
# (d) sizes at the padded widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hid,F,Fd,app", [(32, 15, 4, 0), (96, 15, 4, 0),
                                          (160, 15, 4, APP), (200, 4, 1, 0),
                                          (96, F_WIDE, FD_WIDE, APP),
                                          (1024, 15, 4, 0)])
def test_sizes_agree_at_padded_widths(hid, F, Fd, app):
    """At a padded width the render kernel's stream (``stream_bytes``) is
    what ``pack_mlp`` packs, for the bf16 trunk and the int8 ones; the
    train kernels' stash and gradient workspace (``workspace_bytes``) and
    their product table (``backward_layout``) are those of the kernel
    width; ``pack_train``'s forward images are ``pack_mlp``'s.  At 1024,
    which only the eval kernels take, the eval side alone."""
    _, mlp = make_mlp(hid, F, Fd, app, seed=16)
    cfg, kcfg = mlp.cfg, rtk.kernel_cfg(mlp.cfg, "eval")
    assert kcfg.hid_dim == rtk.kernel_width(hid, "eval") >= hid
    packed = rk.pack_mlp(mlp)
    assert packed[0].numel() * 2 == rk.stream_bytes(cfg) == rk.stream_bytes(kcfg)
    E = rtk.enc_rows(6 * F)
    assert rk.stream_bytes(cfg) == 2 * kcfg.hid_dim * (
        E * 2 + kcfg.hid_dim * (LAYERS - 1) + kcfg.hid_dim
        + rtk.views_cols(kcfg.hid_dim))
    scales = {"enc": torch.ones(6 * F), "acts": [torch.ones(hid)] * LAYERS}
    for start in (0, 2):
        q = quant.pack_kernel_int8(mlp, scales, start, TAP if start == 0 else None)
        w = rk.pack_mlp(mlp, q)
        assert w[0].numel() == rk.stream_bytes(cfg, start)
    if hid == kcfg.hid_dim:   # the real width is the kernel's
        assert rk.pack_mlp(mlp, quant.pack_mlp_int8(mlp, scales, 0, TAP))[
            0].numel() == rk.stream_bytes(cfg, 0)
    else:
        with pytest.raises(ValueError, match="pack_kernel_int8"):
            rk.pack_mlp(mlp, quant.pack_mlp_int8(mlp, scales, 0, TAP))
    if not rtk.train_kernels_take(cfg):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2,"):
            rtk.kernel_cfg(cfg, "train")
        return
    assert kcfg.hid_dim == rtk.kernel_width(hid, "train")
    n, S = 64, 128
    assert rtk.workspace_bytes(cfg, n, S) == rtk.workspace_bytes(kcfg, n, S)
    lay = rtk.backward_layout(cfg, n, S)
    assert lay == rtk.backward_layout(kcfg, n, S)
    H, HV, R = kcfg.hid_dim, kcfg.hid_dim // 2, n * S
    assert lay.products[0] == (E, H, R)
    assert lay.products[-2] == (rtk.dirs_rows(6 * Fd + 3) + app, HV, n)
    assert lay.stash == R * 2 * (E + LAYERS * H + H + HV) + R * 4 * 8 \
        + n * 2 * (rtk.dirs_rows(6 * Fd + 3) + app)
    ptrain = rtk.pack_train(mlp)
    assert torch.equal(ptrain[3 * LAYERS], packed[0])
    assert ptrain[3 * LAYERS + 5].shape == (HV, H)      # wvhT slot images


# ---------------------------------------------------------------------------
# (f) what the kernels take and what they refuse
# ---------------------------------------------------------------------------

def test_config_checks_take_every_width_and_encoding_the_jax_kernels_take():
    """Both wrappers' checks (``check_render_config``, ``check_train_config``)
    accept every hid from 1 to 512, F up to 21 and the view-direction PE up
    to Fd 18 with an appearance table and 20 without; the render check also
    513 to 1024 (run at 1024), where the train check raises
    ``NotImplementedError`` naming ROADMAP Queue 2; both raise it for hid
    1025, and for F = 22 or Fd = 19 with a table; ``kernel_width`` maps each
    width to the smallest instantiated one of its family that holds it.  No
    launch: the checks run on the CPU."""
    def cfg(hid, F=15, Fd=4, app=0):
        return NerfConfig(layer_num=LAYERS, hid_dim=hid, xyz_dim=6 * F,
                          dirs_dim=6 * Fd + 3, app_dim=app, use_viewdirs=True,
                          skips=SKIPS)

    def checks(c, F=15, Fd=4):
        rk.check_render_config(c, F, Fd)
        rtk.check_train_config(_Spec(c, F, Fd))

    for hid in range(1, 257):
        checks(cfg(hid))
        assert rtk.kernel_width(hid, "train") == min(
            w for w in (64, 128, 192, 256) if w >= hid)
        assert rtk.kernel_width(hid, "eval") == rtk.kernel_width(hid, "train")
    checks(cfg(96, F_WIDE, FD_WIDE, APP), F_WIDE, FD_WIDE)
    checks(cfg(96, F_WIDE, 20), F_WIDE, 20)
    # Both families take every width up to 512 (257-511 at 512).
    for hid in (257, 320, 511, 512):
        checks(cfg(hid))
        checks(cfg(hid, F_WIDE, FD_WIDE, APP), F_WIDE, FD_WIDE)
        assert rtk.kernel_width(hid, "eval") == 512
        assert rtk.kernel_width(hid, "train") == 512
    # The eval family takes 513-1024 at 1024; the train family none of them.
    for hid in (513, 640, 1023, 1024):
        rk.check_render_config(cfg(hid), 15, 4)
        rk.check_render_config(cfg(hid, F_WIDE, FD_WIDE, APP), F_WIDE, FD_WIDE)
        assert rtk.kernel_width(hid, "eval") == 1024
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2,"):
            rtk.check_train_config(_Spec(cfg(hid), 15, 4))
    for c, F, Fd in ((cfg(1025), 15, 4), (cfg(2048), 15, 4)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2,"):
            rk.check_render_config(c, F, Fd)
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2,"):
            rtk.check_train_config(_Spec(c, F, Fd))
    for c, F, Fd in ((cfg(96, 22), 22, 4), (cfg(96, 15, 19, APP), 15, 19),
                     (cfg(96, 15, 21), 15, 21), (cfg(96), 14, 4)):
        with pytest.raises(NotImplementedError):
            rk.check_render_config(c, F, Fd)
        with pytest.raises(NotImplementedError):
            rtk.check_train_config(_Spec(c, F, Fd))


@dataclasses.dataclass
class _Spec:
    """A train stage's spec around a bare config (what the checks read)."""
    cfg: NerfConfig
    num_freqs: int
    dirs_freqs: int

    @property
    def mlp(self):
        return self


# ---------------------------------------------------------------------------
# (g) the eval kernels at 512: int8 packing, packing once, the trainer's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hid,start", [(320, 0), (320, 2), (512, 0),
                                       (512, 2), (1024, 0), (1024, 2)])
def test_kernel_int8_at_512_holds_the_jax_quantizer(hid, start):
    """``pack_kernel_int8`` for the tile engine (hid 320 padded to 512, 512
    and 1024 itself) against the JAX quantizer (``pack_mlp_weights_int8``
    of the same weights and scales at the real width): every int8 weight
    on its real rows and columns equal but for 1 LSB on < 0.1% of the
    entries (test_torch_quant.py's rule: f32 scales folded in another
    order), every requant row within rtol 1e-6 on the real columns (and
    atol 1e-7, an f32 step at 0.5: ``B = b q + 0.5`` may be one fused
    multiply-add in XLA, two roundings here, and cancels near 0); the
    padded weights zero and the padded columns at unit activation scale
    (qh 127, B 0.5, iq 1 / 127).  Its s8 slot images keep their K rows in
    order (no PERM32: the engine reads A from a K-major tile in shared
    memory) and unpack to the weights exactly."""
    from nerfmatch_tpu.ops.pallas.quant import pack_mlp_weights_int8

    params, mlp = make_mlp(hid, seed=21)
    rng = np.random.default_rng(22)
    enc = rng.uniform(0.1, 1.0, 90).astype(np.float32)
    acts = [rng.uniform(0.5, 4.0, hid).astype(np.float32)
            for _ in range(LAYERS)]
    tap = TAP if start == 0 else None
    spec = FusedRenderSpec(num_freqs=15, hid_dim=hid, layer_num=LAYERS,
                           skips=SKIPS, feat_layer=TAP, ret_feat=tap is not None,
                           trunk_int8_from=start)
    jw = pack_mlp_weights_int8(params, spec, {"enc": enc, "acts": acts})
    got = quant.pack_kernel_int8(mlp, {"enc": t(enc),
                                       "acts": [t(a) for a in acts]}, start,
                                 tap)
    assert not quant.s8_rows_permuted(512) and quant.s8_rows_permuted(256)
    assert not quant.s8_rows_permuted(1024)
    W = rtk.kernel_width(hid, "eval")
    assert got["w3q"].shape == (W, W)
    # The images: each matrix's rows in order, as slot_images_s8 lays them.
    off = 0
    for i in range(start, LAYERS):
        for k in (f"w{i}q", f"w{i}sq"):
            if k in got:
                img = quant.slot_images_s8(got[k], permute=False)
                assert torch.equal(got["img"][off:off + img.numel()], img), k
                K, N = got[k].shape
                assert torch.equal(unslot_s8(img, K, N, False), got[k]), k
                off += img.numel()
    assert off == got["img"].numel()
    keys = [k for k in got if k not in ("start", "tap", "img")]
    assert set(keys) <= set(jw) and not any(
        k.endswith("q") and k not in got for k in jw)
    for k in keys:
        g, ref = got[k], np.asarray(jw[k])
        assert torch.isfinite(g.float()).all(), k
        if k.startswith("w"):
            rows = ref.shape[0] if k.endswith("sq") or k == "w0q" else hid
            rows = min(rows, g.shape[0])
            _int8_equal(g[:rows, :hid].numpy(), ref[:rows, :hid])
            assert not g[:, hid:].any() and not g[rows:].any(), k
        else:
            g = g.reshape(-1)
            np.testing.assert_allclose(g[:hid].numpy() if g.numel() >= hid
                                       else g.numpy(),
                                       ref.reshape(-1)[:min(hid, g.numel())],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            pad = g[hid:] if k != "qenc" else g[:0]
            if k == "qh":
                assert torch.all(pad == 127.0), k
            elif k.startswith("B"):
                assert torch.all(pad == 0.5), k
            elif k.startswith("iq"):
                assert torch.all(pad == np.float32(1.0) / np.float32(127.0)), k


def _int8_equal(ours, ref):
    """int8 weights equal, except at most 1 LSB on < 0.1% of the entries
    (test_torch_quant.py's rule)."""
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("hid", [96, 320, 512])
def test_pack_stage_pads_once_with_the_same_bytes(hid):
    """``render_kernel.pack_stage`` (the stage's MLP padded once, handed to
    both packers; ``NerfRenderer.pack_fused``'s CUDA route) packs the bytes
    of ``pack_mlp(mlp, pack_kernel_int8(mlp, ...))`` (which pads twice):
    the bf16 stage, the int8 trunk from layer 0 with the tap, and the
    'posttap' trunk, every packed tensor and every int8 row equal; the
    stream is ``stream_bytes``'s at the eval width."""
    _, mlp = make_mlp(hid, seed=23)
    rng = np.random.default_rng(24)
    scales = {"enc": t(rng.uniform(0.1, 1.0, 90)),
              "acts": [t(rng.uniform(0.5, 4.0, hid)) for _ in range(LAYERS)]}
    for start, tap in ((None, None), (0, TAP), (TAP + 1, TAP)):
        got_w, got_q = rk.pack_stage(mlp, scales, start, tap)
        ref_q = (None if start is None
                 else quant.pack_kernel_int8(mlp, scales, start, tap))
        ref_w = rk.pack_mlp(mlp, ref_q)
        assert len(got_w) == len(ref_w)
        for a, b in zip(got_w, ref_w):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)
        assert got_w[0].numel() * got_w[0].element_size() == \
            rk.stream_bytes(mlp.cfg, start)
        if start is None:
            assert got_q is None
            continue
        assert set(got_q) == set(ref_q)
        for k, v in ref_q.items():
            assert (got_q[k] == v) if not torch.is_tensor(v) \
                else torch.equal(got_q[k], v), k


def test_width_sets_by_family():
    """The train kernels' widths are (64, 128, 192, 256, 512), the eval
    kernels' the same and 1024: each width up to a family's largest maps to
    the smallest that holds it; 513 raises in the train family and 1025 in
    the eval family, naming ROADMAP Queue 2 and the width refused."""
    assert rtk.EVAL_HIDS == (64, 128, 192, 256, 512, 1024)
    assert rtk.TRAIN_HIDS == (64, 128, 192, 256, 512)
    for family in ("eval", "train"):
        assert rtk.kernel_width(512, family) == 512
        assert rtk.kernel_width(257, family) == 512
        assert rtk.kernel_width(256, family) == 256
    with pytest.raises(NotImplementedError,
                       match="hid_dim 513 > 512 .ROADMAP Queue 2, MLP "
                             "widths above 512"):
        rtk.kernel_width(513, "train")
    for hid in (513, 640, 1024):
        assert rtk.kernel_width(hid, "eval") == 1024
    with pytest.raises(NotImplementedError,
                       match="hid_dim 1025 > 1024 .ROADMAP Queue 2, MLP "
                             "widths above 1024"):
        rtk.kernel_width(1025, "eval")
    cfg = NerfConfig(layer_num=LAYERS, hid_dim=320, xyz_dim=90, dirs_dim=27,
                     use_viewdirs=True, skips=SKIPS)
    assert rtk.kernel_cfg(cfg, "eval").hid_dim == 512
    assert rtk.kernel_cfg(cfg, "train").hid_dim == 512
    assert rtk.train_kernels_take(cfg)
    assert not rtk.train_kernels_take(dataclasses.replace(cfg, hid_dim=513))
    assert rtk.kernel_cfg(dataclasses.replace(cfg, hid_dim=640),
                          "eval").hid_dim == 1024


@pytest.mark.parametrize("hid,route", [(640, "plain"), (512, "kernels"),
                                       (320, "kernels"), (256, "kernels"),
                                       (96, "kernels")])
def test_trainer_route_follows_the_train_kernels_widths(hid, route):
    """``nerf_trainer.train_route`` on a CUDA device string, from the
    config alone (no launch, nothing moved to a card): a NeRF whose MLP the
    train kernels hold (every width up to 512) takes the kernels, a wider
    one the plain route with the reason without ``render.use_fused_train``
    (``fused_eval_supported`` is a function of the config, not of its
    width) and raises with the flag, on CUDA or on the CPU; on the CPU
    without the flag every width is plain."""
    from nerfmatch_tpu_torch.config import dict2namespace
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.train.nerf_trainer import train_route

    nerf = {"method": "NeRF", "layer_num": 2, "hid_dim": hid,
            "output_dim": 4, "skips": [], "num_pts": 128}
    r = NerfRenderer(dict2namespace({
        "render": {"use_viewdirs": True, "white_bg": False},
        "embedding": {"xyz_num_freqs": 15, "dirs_num_freqs": 4,
                      "type": "mip"},
        "coarse_nerf": nerf, "fine_nerf": nerf}), stop_layer=1)
    assert r.fused_eval_supported
    got, why = train_route(r, "cuda")
    assert got == route
    assert (why == "") == (route == "kernels")
    if route == "plain":
        assert f"hid_dim {hid}" in why and "512" in why and "1024" in why
    assert train_route(r, "cpu")[0] == "plain"
    for dev in ("cuda", "cpu"):
        if route == "plain":
            with pytest.raises(NotImplementedError,
                               match="ROADMAP Queue 2, MLP widths above 512"):
                train_route(r, dev, use_fused_train=True)
        else:
            assert train_route(r, dev, use_fused_train=True) == (route, "")
