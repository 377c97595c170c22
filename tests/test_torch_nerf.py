"""Port parity: NeRF ops, renderer and the render / resample kernels' plain
versions against the JAX package on the CPU.

The same seeded numpy inputs and the same weights (JAX params exported
through the weight bridge) go through both packages, in f32; the fused
render's MLP takes bf16 operands on both sides, as the kernels do.
Tolerances are stated per test; the Pallas comparisons run the JAX kernels
in interpret mode, as the JAX package's own tests do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.config import dict2namespace
from nerfmatch_tpu.nerf import compositing as jcomp
from nerfmatch_tpu.nerf import embedding as jemb
from nerfmatch_tpu.nerf import rays as jrays
from nerfmatch_tpu.nerf import sampling as jsamp
from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer
from nerfmatch_tpu.nerf.scene import rays_intersect_sphere as j_isect
from nerfmatch_tpu.train.checkpoint import export_torch_state_dict

from nerfmatch_tpu_torch.nerf import compositing as tcomp
from nerfmatch_tpu_torch.nerf import embedding as temb
from nerfmatch_tpu_torch.nerf import rays as trays
from nerfmatch_tpu_torch.nerf import sampling as tsamp
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.nerf.scene import rays_intersect_sphere as t_isect
from nerfmatch_tpu_torch.ops.kernels.quant import PERM32, slot_images_s8
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
    early_term_mask, mlp_plain, pack_mlp, render_stage_plain, stream_bytes)
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import resample_z
from nerfmatch_tpu_torch.train.checkpoint import (load_npz_params,
                                                  state_dict_from_jax)

torch.set_num_threads(2)

HID = 64
ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def nerf_config(hid=HID, **render):
    return dict2namespace({
        "data": {"img_wh": [64, 64]},
        "render": {"chunksize": 4096, "use_viewdirs": True, "use_disp": False,
                   "perturb": False, "white_bg": False, "noise_std": 0.0,
                   "trunk_int8": "none", **render},
        "embedding": {"xyz_num_freqs": 15, "dirs_num_freqs": 4, "type": "mip"},
        "coarse_nerf": {"method": "NeRF", "layer_num": 8, "hid_dim": hid,
                        "output_dim": 4, "skips": [4], "num_pts": 128},
        "fine_nerf": {"method": "NeRF", "layer_num": 8, "hid_dim": hid,
                      "output_dim": 4, "skips": [4], "num_pts": 128},
    })


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in p):
            np.asarray(v) for p, v in flat}


def make_rays(n, seed, nonunit=False):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rd = d * (1.3 if nonunit else 1.0)
    return np.concatenate([o, rd, np.full((n, 1), 0.05), np.full((n, 1), 1.4),
                           d, np.full((n, 1), 0.002)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(jax renderer, jax params, port renderer) with shared weights; the
    MLP output biases are shifted so the field is partly opaque."""
    cfg = nerf_config()
    jr = JaxRenderer(cfg, stop_layer=3)
    params = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 3.0
    tr = NerfRenderer(cfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jr, params, tr


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_embeddings_match():
    """PE / IPE / Fourier at atol 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 5, 3)).astype(np.float32)
    v = rng.uniform(0, 1e-3, (7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(temb.pe_embedding(t(x), 4).numpy(),
                               jemb.pe_embedding(jnp.asarray(x), 4), atol=1e-5)
    np.testing.assert_allclose(temb.fourier_embedding(t(x), 6).numpy(),
                               jemb.fourier_embedding(jnp.asarray(x), 6),
                               atol=1e-5)
    for a, b in zip(temb.ipe_embedding(t(x), t(v), 8),
                    jemb.ipe_embedding(jnp.asarray(x), jnp.asarray(v), 8)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


def test_rays_and_sphere_match():
    """sample_nerf_rays (12-col packing, ds grid, sphere far plane) at 1e-5."""
    K = np.array([[40.0, 0, 32], [0, 40.0, 32], [0, 0, 1]], np.float32)
    ang = 0.7
    c2w = np.eye(4, dtype=np.float32)
    c, s = np.cos(ang), np.sin(ang)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = [0.3, -0.1, 0.2]
    ours = trays.sample_nerf_rays(64, 48, t(K), t(c2w), ds=8).numpy()
    ref = np.asarray(jrays.sample_nerf_rays(64, 48, jnp.asarray(K),
                                            jnp.asarray(c2w), ds=8))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    o = np.array([[2.0, 0, 0], [0.1, 0.2, 0.0]], np.float32)
    d = np.array([[1.0, 0, 0], [0.0, 0.6, 0.8]], np.float32)
    a, b = t_isect(t(o), t(d)).numpy(), np.asarray(j_isect(jnp.asarray(o),
                                                           jnp.asarray(d)))
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], atol=1e-5)


def test_sampling_and_compositing_match():
    """Gaussian cast, weight-blurred resampling and volume rendering at 1e-5."""
    rays = make_rays(12, 1, nonunit=True)
    o, d, r = rays[:, :3], rays[:, 3:6], rays[:, 11:12]
    near, far = rays[:, 6:7], rays[:, 7:8]
    jz, (jm, jv) = jsamp.sample_gaussians_along_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(r), 128, jnp.asarray(near),
        jnp.asarray(far))
    tz, (tm, tv) = tsamp.sample_gaussians_along_rays(t(o), t(d), t(r), 128,
                                                     t(near), t(far))
    for a, b in ((tz, jz), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
    rng = np.random.default_rng(2)
    field = rng.normal(size=(12, 128, 4)).astype(np.float32)
    field[..., 3] = np.abs(field[..., 3]) * 20
    jout = jcomp.volume_render(jnp.asarray(field), jz, jnp.asarray(d),
                               white_bg=True)
    tout = tcomp.volume_render(t(field), tz, t(d), white_bg=True)
    for k in ("rgb", "depth", "acc", "weights", "disp"):
        np.testing.assert_allclose(tout[k].numpy(), jout[k], atol=1e-5,
                                   rtol=1e-5)
    feats = rng.normal(size=(12, 128, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tcomp.composite_features(tout["weights"], t(feats)).numpy(),
        jcomp.composite_features(jout["weights"], jnp.asarray(feats)),
        atol=1e-5)
    np.testing.assert_allclose(
        tsamp.resample_z_from_weights(tz, tout["weights"]).numpy(),
        jsamp.resample_z_from_weights(jz, jout["weights"]), atol=1e-5)


def test_nerf_mlp_matches(pair):
    """NeRF MLP (skip at 4, layer-3 tap, heads) at atol 1e-5."""
    from nerfmatch_tpu.nerf.model import nerf_apply

    jr, params, tr = pair
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 9, jr.fine_cfg.xyz_dim + jr.fine_cfg.dirs_dim))
    x = x.astype(np.float32)
    jout, jfeat = nerf_apply(params["nerf_fine"], jr.fine_cfg, jnp.asarray(x),
                             val=True)
    with torch.no_grad():
        tout, tfeat = tr.nerf_fine(t(x))
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(tfeat.numpy(), jfeat, atol=1e-5)


def test_render_rays_matches_xla_path(pair):
    """Plain eval render vs the JAX XLA path.  Coarse outputs at 1e-4;
    resampled (fine) outputs judged by mean and p99 of the error, since the
    resample is chaotic at silhouette edges."""
    jr, params, tr = pair
    rays = make_rays(32, 4, nonunit=True)
    ref = jr.render_rays(params, jnp.asarray(rays), train=False,
                         ret_pfeat=True, validation=True)
    with torch.no_grad():
        ours = tr.render_rays(t(rays))
    for k in ("rgb_coarse", "depth_coarse", "pts_coarse", "feat_coarse"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=1e-4)
    for k in ("rgb_fine", "depth_fine", "pts_fine", "feat_fine"):
        err = np.abs(ours[k].numpy() - np.asarray(ref[k]))
        assert err.mean() < 1e-5 and np.quantile(err, 0.99) < 1e-4, (k, err.max())


def test_resample_plain_matches_pallas():
    """Resample kernel's plain version vs resample_z_pallas(interpret) at 1e-5."""
    from nerfmatch_tpu.ops.pallas.resample_kernel import resample_z_pallas

    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(0.05, 1.4, (16, 129)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(16, 128)).astype(np.float32)
    w[3] = 0.0                      # degenerate all-zero row: eps padding
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-9) * 1.2
    ref = resample_z_pallas(jnp.asarray(z), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(resample_z(t(z), t(w)).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("eps", [0.0, 1e-4])
def test_fused_render_plain_matches_pallas(pair, eps):
    """fused_render through the kernels' plain versions vs
    make_fused_hierarchical(interpret=True): the Pallas trunk is bf16, so
    2e-2 (the JAX fused-vs-XLA tolerance) on rgb/depth/pts and 0.1 relative
    on features; early termination moves outputs by < eps."""
    from nerfmatch_tpu.ops.pallas.render_kernel import make_fused_hierarchical

    jr, params, tr = pair
    jr.fused_interpret = True
    rays = make_rays(16, 6, nonunit=True)
    render, pack = make_fused_hierarchical(jr, interpret=True, ray_tile=8,
                                           early_term_eps=eps)
    wc, wf = pack(params)
    ref = render(wc, wf, jnp.asarray(rays))
    tr_eps = NerfRenderer(nerf_config(early_term_eps=eps), stop_layer=3)
    tr_eps.load_state_dict(tr.state_dict())
    with torch.no_grad():
        ours = tr_eps.fused_render(t(rays))
    for k in ("rgb_fine", "depth_fine", "pts_fine", "depth_coarse", "acc_fine"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=2e-2)
    f_rel = (np.abs(ours["feat_fine"].numpy() - np.asarray(ref["feat_fine"])).max()
             / (np.abs(np.asarray(ref["feat_fine"])).max() + 1e-9))
    assert f_rel < 0.1, f_rel


def test_fused_plain_matches_render_rays(pair, monkeypatch):
    """The fused plain path with an f32 MLP agrees with the plain
    render_rays path (same f32 math in another association): coarse depth
    1e-4, fine outputs by mean 1e-5 / p99 1e-4."""
    from nerfmatch_tpu_torch.nerf import renderer as renderer_mod

    monkeypatch.setattr(renderer_mod, "render_stage",
                        lambda *a, packed=None, **kw: render_stage_plain(
                            *a, trunk_bf16=False, **kw))
    jr, params, tr = pair
    rays = make_rays(32, 7)
    tr0 = NerfRenderer(nerf_config(early_term_eps=0.0), stop_layer=3)
    tr0.load_state_dict(tr.state_dict())
    with torch.no_grad():
        a = tr0.fused_render(t(rays))
        b = tr0.render_rays(t(rays))
    np.testing.assert_allclose(a["depth_coarse"].numpy(),
                               b["depth_coarse"].numpy(), atol=1e-4)
    for k in ("rgb_fine", "depth_fine", "pts_fine", "feat_fine"):
        err = np.abs(a[k].numpy() - b[k].numpy())
        assert err.mean() < 1e-5 and np.quantile(err, 0.99) < 1e-4, (k, err.max())


# The K position of row k of a 32-row block in an s8 image fed from an
# accumulator: the s32 accumulator gives a thread (q = lane % 4) columns
# 8 j + 2 q (+ 1), its s8 A fragment takes k = 4 q + r and 16 + 4 q + r
# (the wgmma .s8 register fragment, mma.sync m16n8k32's A), so position
# 4 q + r (+ 16) holds row 8 (r // 2) + 2 q + r % 2 (+ 16).
PI = np.array([16 * hi + 8 * (r // 2) + 2 * q + r % 2
               for hi in (0, 1) for q in range(4) for r in range(4)])


def unslot_s8(img, K, N, permute):
    """A (K, N) int8 matrix back from its s8 slot images, the layout written
    out here: row k sits at position k' (k' = k, or the 32-row block's
    position p with PI[p] = k % 32 where ``permute``), in slot k' // 64,
    column n (64 bytes each), 16-byte chunk ((k' % 64) // 16) ^ ((n // 2) %
    4), byte k' % 16."""
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    pos = k // 32 * 32 + np.argsort(PI)[k % 32] if permute else k
    off = (pos // 64 * 64 * N + n * 64
           + (((pos % 64) // 16) ^ ((n // 2) % 4)) * 16 + pos % 16)
    return img[torch.from_numpy(off)]


@pytest.mark.parametrize("permute", [False, True])
def test_pack_fragments_layout(permute):
    """The int8 weights' slot images (slot_images_s8) hold w[k, n] (K
    zero-padded to 64) in the layout the render kernel's s8 wgmma reads:
    per 64-row slot K-major columns of 64 bytes in the 64-byte swizzle, the
    rows of each 32-row block in PI's order where they are fed from an
    accumulator; PERM32 is PI, a permutation."""
    assert sorted(PI) == list(range(32))
    assert torch.equal(PERM32, torch.from_numpy(PI))
    w = torch.from_numpy(np.random.default_rng(0).integers(
        -127, 128, size=(90, 64)).astype(np.int8))
    img = slot_images_s8(w, permute)
    assert img.shape == (128 * 64,) and img.dtype == torch.int8
    assert torch.equal(unslot_s8(img, 128, 64, permute),
                       torch.cat([w, torch.zeros(38, 64, dtype=torch.int8)]))


def unslot(img, K, N):
    """A (K, N) matrix back from its slot images, the layout written out
    here: element (k, n) sits in slot k // 32, 64-column block n // 64, row
    k % 32, 16-byte chunk ((n % 64) // 8) ^ (k % 8), place n % 8."""
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    r = k % 32
    off = ((k // 32) * 32 * N + (n // 64) * 32 * 64 + r * 64
           + (((n % 64) // 8) ^ (r % 8)) * 8 + n % 8)
    return img[torch.from_numpy(off)]


def test_pack_mlp_slot_images_hold_the_weights(pair):
    """The bf16 render kernel's weights (pack_mlp): unpacked from the slot
    images, every matrix equals its (in x out) bf16 weight, in the order
    the ring streams them, the encoding rows zero-padded to 96 and the
    views' columns to 64; the encoding flags sit at layer 0 and the skip
    layer; the biases, the sigma head, wvd and wr stay f32, unrounded; wva
    (the appearance rows) is None without a table."""
    _, _, tr = pair
    mlp = tr.nerf_fine
    cfg = mlp.cfg
    hid, enc, L = cfg.hid_dim, cfg.xyz_dim, cfg.layer_num
    packed = pack_mlp(mlp)
    imgs = packed[0]
    assert imgs.dtype == torch.bfloat16 and imgs.dim() == 1
    mats = []
    for i, lin in enumerate(mlp.pts_linears):
        w = lin.weight.detach().t()
        if i == 0 or i - 1 in cfg.skips:
            mats.append(torch.nn.functional.pad(w[:enc], (0, 0, 0, 96 - enc)))
            w = w[enc:]
        if i > 0:
            mats.append(w)
    views = mlp.views_linears[0].weight.detach().t()[:hid]
    mats += [mlp.feature_linear.weight.detach().t(),
             torch.nn.functional.pad(views, (0, max(hid // 2, 64) - hid // 2))]
    off = 0
    for j, m in enumerate(mats):
        K, N = m.shape
        got = unslot(imgs[off:off + K * N], K, N)
        assert torch.equal(got, m.to(torch.bfloat16)), j
        off += K * N
    assert off == imgs.numel()
    flags, biases = packed[1:1 + 2 * L:2], packed[2:2 + 2 * L:2]
    assert [f is not None for f in flags] == [
        i == 0 or i - 1 in cfg.skips for i in range(L)]
    for b, lin in zip(biases, mlp.pts_linears):
        assert torch.equal(b, lin.bias)
    wa, ba, bf, wvd, wva, bv, wr, br = packed[1 + 2 * L:]
    assert wva is None
    views_w = mlp.views_linears[0].weight
    for got, ref in ((wa, mlp.alpha_linear.weight[0]),
                     (ba, mlp.alpha_linear.bias), (bf, mlp.feature_linear.bias),
                     (wvd, views_w[:, hid:].t()), (bv, mlp.views_linears[0].bias),
                     (wr, mlp.rgb_linear.weight.t()), (br, mlp.rgb_linear.bias)):
        assert got.dtype == torch.float32 and torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["none", "coarse", "both", "posttap"])
def test_pack_fused_packs_each_stage_for_its_kernel(pair, mode, monkeypatch):
    """On CUDA, pack_fused gives each stage the render kernel's weights for
    its trunk: the bf16 slot images for a bf16 stage, and for a stage that
    int8_plan quantizes the stream of its bf16 layers' images, its int8
    trunk's s8 images and the heads' images (in bytes, as many as
    stream_bytes says), each what pack_mlp of that MLP and trunk gives (the
    renderer presented as a CUDA one, its weights on the CPU); on the CPU
    no kernel weights at all."""
    _, _, tr = pair
    r = NerfRenderer(nerf_config(trunk_int8=mode), stop_layer=3)
    r.load_state_dict(tr.state_dict())
    if mode != "none":
        r.calibrate_int8(t(make_rays(16, 3)))
    assert all(w is None for w, _ in r.pack_fused())
    monkeypatch.setattr(NerfRenderer, "device",
                        property(lambda self: torch.device("cuda")))
    packed = r.pack_fused()
    for (_, mlp), start, (w, q) in zip(r._stages(), r.int8_plan(), packed):
        assert (q is None) == (start is None)
        ref = pack_mlp(mlp, q)
        assert w[0].dtype == (torch.bfloat16 if q is None else torch.uint8)
        assert w[0].numel() * w[0].element_size() == stream_bytes(
            mlp.cfg, None if q is None else q["start"])
        if q is not None:   # [bf16 layers below start | s8 trunk | heads]
            bf16 = pack_mlp(mlp)[0].view(torch.uint8)
            hid, skips = mlp.cfg.hid_dim, mlp.cfg.skips
            at = sum(2 * hid * (96 * (i == 0 or i - 1 in skips) + hid * (i > 0))
                     for i in range(q["start"]))
            heads = 2 * hid * (hid + max(hid // 2, 64))
            n_img = q["img"].numel()
            assert w[0].numel() == at + n_img + heads
            assert torch.equal(w[0][:at], bf16[:at])
            assert torch.equal(w[0][at:at + n_img], q["img"].view(torch.uint8))
            assert torch.equal(w[0][at + n_img:], bf16[-heads:])
        assert len(w) == len(ref)
        for a, b in zip(w, ref):
            assert (a is None and b is None) or torch.equal(a, b)


def test_mlp_plain_bf16_rounds_only_matmul_operands(pair):
    """trunk_bf16 moves the MLP outputs by bf16 operand rounding only
    (relative 3e-2 of each output's range), and trunk_bf16=False is the
    module's own f32 forward (1e-5)."""
    jr, params, tr = pair
    mlp = tr.nerf_fine
    rng = np.random.default_rng(4)
    enc = t(rng.normal(size=(16, 5, mlp.cfg.xyz_dim)))
    dirs = t(rng.normal(size=(16, 1, mlp.cfg.dirs_dim)))
    with torch.no_grad():
        raw, tap_ref = mlp(torch.cat([enc, dirs.expand(-1, 5, -1)], -1))
        f32 = mlp_plain(mlp, enc, dirs, 3, trunk_bf16=False)
        bf = mlp_plain(mlp, enc, dirs, 3, trunk_bf16=True)
    for a, b in zip(f32, (raw[..., 3], raw[..., :3], tap_ref)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    for a, b in zip(bf, f32):
        assert (a - b).abs().max() <= 3e-2 * (b.abs().max() + 1e-6)
        assert not torch.equal(a, b)


def test_early_term_mask_semantics():
    """Tiles of 2 rays skip a 32-sample block only when both rays are
    opaque; block 0 always runs; a skipped block stays skipped."""
    alpha = torch.zeros(4, 128)
    alpha[0:2, 5] = 1.0              # tile 0: both opaque inside block 0
    alpha[2, 40] = 1.0               # tile 1: only one ray opaque
    m = early_term_mask(alpha, 1e-4)
    assert not m[:, :32].any()
    assert m[0:2, 32:].all()
    assert not m[2:4].any()
    assert not early_term_mask(alpha, 0.0).any()


def test_fused_cuda_rejects_unported_configs():
    """Configs the kernels do not implement raise instead of taking the
    plain path: feat_comb 'lin' and 'max' and every int8 mode are
    implemented; an unknown feat_comb or int8 mode raises, and so do
    unequal coarse and fine sample counts."""
    NerfRenderer(nerf_config(feat_comb="max"), stop_layer=3
                 ).check_fused_supported()
    with pytest.raises(ValueError):
        NerfRenderer(nerf_config(feat_comb="mean"), stop_layer=3
                     ).check_fused_supported()
    cfg = nerf_config()
    cfg.fine_nerf.num_pts = 64
    with pytest.raises(NotImplementedError):
        NerfRenderer(cfg, stop_layer=3).check_fused_supported()
    for mode in ("none", "coarse", "both", "posttap"):
        NerfRenderer(nerf_config(trunk_int8=mode),
                     stop_layer=3).check_fused_supported()
    with pytest.raises(ValueError):
        NerfRenderer(nerf_config(trunk_int8="fp8"),
                     stop_layer=3).check_fused_supported()


def test_bridge_matches_export_for_nerf_fixture():
    """state_dict_from_jax == export_torch_state_dict(prefix='') key for key
    and value for value on the room fixture; strict load succeeds."""
    flat = load_npz_params(ROOT / "pretrained" / "synthetic_room_nerf.npz")
    cfg = nerf_config(hid=256)
    jr = JaxRenderer(cfg, stop_layer=3)
    tmpl = jr.init_params(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tmpl)
    keys = ["/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in p)
            for p, _ in leaves]
    params = jax.tree_util.tree_unflatten(
        treedef, [np.asarray(flat[k], np.float32) for k in keys])
    ref = export_torch_state_dict(params, prefix="")
    ours = state_dict_from_jax(flat)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    NerfRenderer(cfg, stop_layer=3).load_state_dict(ours, strict=True)


def test_fused_predict_pads_and_chunks(pair):
    """An odd ray count over several chunks equals one padded fused_render
    (tile padding and chunk stitching; exact, same arithmetic per ray)."""
    jr, params, tr = pair
    rays = t(make_rays(11, 8))
    with torch.no_grad():
        a = tr.fused_predict(rays, chunk_rays=4)
        b = tr.fused_render(torch.cat([rays, rays[-1:]]))
    for k in b:
        torch.testing.assert_close(a[k], b[k][:11], atol=0, rtol=0)


def test_render_novel_views_batches_like_single_views(pair):
    """render_novel_views(B=2) == stacked render_novel_view calls, and the
    points come back in world coordinates."""
    jr, params, tr = pair
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    un = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    c2ws = [np.eye(4, dtype=np.float32) for _ in range(2)]
    c2ws[1][:3, 3] = [0.2, 0.0, -0.1]
    many = tr.render_novel_views((32, 32), [K, K], c2ws, [un, un])
    for b in range(2):
        one = tr.render_novel_view((32, 32), K, c2ws[b], un)
        for k in one:
            np.testing.assert_allclose(many[k][b], one[k], atol=1e-6)
    ref = jr.render_novel_view(params, (32, 32), K, c2ws[1], un)
    err = np.abs(many["pt3d"][1] - np.asarray(ref["pt3d"]))
    assert err.mean() < 1e-5 and np.quantile(err, 0.99) < 2e-4, err.max()
