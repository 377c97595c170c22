"""Card-only tests: each CUDA kernel of the port against its plain PyTorch
version on the same inputs.  Marked ``cuda``; they skip without a GPU.
This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmatch_tpu.config import dict2namespace
from nerfmatch_tpu_torch.models.layers import init_params_
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.ops import kernels
from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nerfmatch_tpu_torch.ops.kernels import attention_kernel
from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
    attention_bwd, attention_bwd_plain, attention_onepass_plain,
    attention_plain, fused_attention)
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
    early_term_mask, render_stage, render_stage_plain, stage_alpha_plain)
from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
    StageSpec, _kernel_args, _sizes, kernel_forward, pack_train, render_train,
    render_train_plain, workspace_bytes)
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (resample_z,
                                                             resample_z_plain)
from nerfmatch_tpu_torch.ops.kernels.sepconv_kernel import (
    dw_star, dw_star_dgrad, dw_star_dgrad_plain, dw_star_fwd, dw_star_plain,
    dw_star_wgrad, dw_star_wgrad_plain)
from nerfmatch_tpu_torch.nerf.model import NerfConfig, NerfMLP


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def renderer(hid, dev):
    nerf = {"method": "NeRF", "layer_num": 8, "hid_dim": hid, "output_dim": 4,
            "skips": [4], "num_pts": 128}
    cfg = dict2namespace({
        "render": {"use_viewdirs": True, "white_bg": False},
        "embedding": {"xyz_num_freqs": 15, "dirs_num_freqs": 4, "type": "mip"},
        "coarse_nerf": nerf, "fine_nerf": nerf})
    r = init_params_(NerfRenderer(cfg, stop_layer=3),
                     torch.Generator().manual_seed(0))
    with torch.no_grad():
        r.nerf_fine.alpha_linear.bias += 3.0      # partly opaque field
    return r.to(dev).eval()


def rays_z(n, dev, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.05), np.full((n, 1), 1.4),
                           d, np.full((n, 1), 0.002)], -1).astype(np.float32)
    rays = torch.from_numpy(rays).to(dev)
    t = torch.linspace(0, 1, 129, device=dev)
    z = (rays[:, 6:7] * (1 - t) + rays[:, 7:8] * t).contiguous()
    return rays, z


@pytest.mark.cuda
@pytest.mark.parametrize("hid,eps", [(256, 0.0), (256, 1e-4), (64, 1e-4),
                                     (32, 1e-4), (96, 1e-4), (128, 1e-4),
                                     (192, 1e-4), (512, 0.0), (512, 1e-4),
                                     (320, 1e-4), (640, 1e-4), (1024, 0.0),
                                     (1024, 1e-4)])
def test_render_kernel_matches_plain(dev, hid, eps):
    """Coarse and fine variants against the plain version with the same
    bf16 MLP operands at atol/rtol 5e-3 (f32 accumulation order, and bf16
    rounding ties that the two sides break apart), and against the f32-MLP
    plain version at 2e-2 (the JAX fused-vs-XLA tolerance; features
    relative to their largest value).  Every instantiated width (64, 128,
    192, 256, 512, 1024) and four that run zero-padded (32 at 64, 96 at
    128, 320 at 512, 640 at 1024)."""
    r = renderer(hid, dev)
    rays, z = rays_z(64, dev)
    reset_launch_counts()
    kw = dict(num_freqs=15, dirs_freqs=4, early_term_eps=eps)
    with torch.no_grad():
        for fine in (False, True):
            a = render_stage(r.nerf_fine, rays, z, fine=fine, **kw)
            b = render_stage_plain(r.nerf_fine, rays, z, fine=fine, **kw)
            c = render_stage_plain(r.nerf_fine, rays, z, fine=fine,
                                   trunk_bf16=False, **kw)
            for k in b:
                torch.testing.assert_close(a[k], b[k], atol=5e-3, rtol=5e-3)
                scale = float(c[k].abs().max()) if k == "feat" else 1.0
                assert float((a[k] - c[k]).abs().max()) <= 2e-2 * scale, k
    assert LAUNCHES["render_coarse"] == LAUNCHES["render_fine"] == 1


def opaque_renderer(hid, dev, n, seed=1):
    """A denser field (the fine MLP's alpha bias up by 4 more) and far
    planes spread over 0.3-6: at eps 1e-4 tiles die after one, two or three
    32-sample blocks, or run to the end.  -> (renderer, rays, z)."""
    r = renderer(hid, dev)
    with torch.no_grad():
        r.nerf_fine.alpha_linear.bias += 4.0
    rays, _ = rays_z(n, dev, seed)
    g = torch.Generator().manual_seed(seed)
    rays[:, 7] = (0.3 + 5.7 * torch.rand(n, generator=g)).to(dev)
    t = torch.linspace(0, 1, 129, device=dev)
    z = (rays[:, 6:7] * (1 - t) + rays[:, 7:8] * t).contiguous()
    return r, rays, z


def stage_trunks(r, rays, trunk):
    """The int8 trunks of the fine MLP's coarse and fine stages in mode
    ``trunk`` (the coarse stage from layer 0; 'both': the fine stage from
    layer 0, 'posttap': after its tap layer), scales calibrated from these
    rays -> {fine: int8 trunk}; both None for 'bf16'."""
    from nerfmatch_tpu_torch.nerf.model import eval_feat_layer
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_mlp_int8)

    if trunk == "bf16":
        return {False: None, True: None}
    mlp = r.nerf_fine
    scales = calibrate_act_scales(r, rays)["fine"]
    tap = eval_feat_layer(mlp.cfg)
    return {False: pack_mlp_int8(mlp, scales, 0),
            True: pack_mlp_int8(mlp, scales,
                                0 if trunk == "both" else tap + 1, tap)}


def int8_flips_held(a, b, hid):
    """The kernel's integer activations ``a`` against the plain version's
    ``b``: fewer than 1e-3 of them apart up to hid 256.  At 512 fewer than
    2e-3, each one step: the 'posttap' trunk's bf16 prefix sums 512-long
    products, the kernel on the tensor cores and the plain version in f32
    FMAs in another order, so more requantized values land on either side
    of a rounding boundary, and the s8 layers after it carry a flipped
    input on.  Measured on the card (``scripts/int8_flip_witness.py``, 64
    rays, 10 seeds of weights and rays, seed 0 this file's): 'posttap'
    9.9e-4 to 1.30e-3 at 512, 2.2e-4 to 3.1e-4 at 256, each one step; against
    a reference whose prefix sums in f64 the kernel is 9.8e-4 to 1.24e-3
    apart and the plain version 4.8e-4 to 6.8e-4 (256: 1.6e-4 to 3.0e-4
    and 1.2e-4 to 2.2e-4), so neither side is exact and the flips follow
    the prefix's rounding; 'both' (no bf16 prefix) at most 1.5e-5, only
    where one encoding value rounds apart (sinf against torch's).  2e-3
    is 1.5x the largest of those readings.  Above 512 (kernel width 1024)
    fewer than 8.4e-3, at most two steps: the prefix sums are 1024 long;
    the same witness at 1024 read 'posttap' 4.9e-3 to 5.6e-3 apart, up to
    two steps, the kernel 1.1e-2 and the plain version 8.6e-3 from f64 at
    most, 'both' at most 1.4e-5 (8.4e-3 is 1.5x the largest reading)."""
    flips = float((a != b).float().mean())
    step = int((a.int() - b.int()).abs().max())
    if hid <= 256:
        return flips < 1e-3
    if hid <= 512:
        return flips < 2e-3 and step <= 1
    return flips < 8.4e-3 and step <= 2


def scaled_max_err(a, b):
    """Largest absolute error over the outputs, relative to each output's
    largest value where that exceeds 1 (chip_smoke.py's render check)."""
    return max(float((a[k] - b[k]).abs().max())
               / max(1.0, float(b[k].abs().max())) for k in b)


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [256, 512, 1024])
@pytest.mark.parametrize("trunk", ["bf16", "both", "posttap"])
def test_render_eval_zero_weights_match_early_term_mask(dev, trunk, hid):
    """At eps 1e-4 the kernel (a bf16 trunk, or the int8 trunk of
    ``trunk``) skips the blocks early_term_mask marks on the plain version's
    alpha: its weights there are exact zeros, and a (tile, block) the mask
    keeps is all-zero in the kernel's weights only where it is all-zero in
    the plain version's."""
    r, rays, z = opaque_renderer(hid, dev, 512)
    mlp, q8 = r.nerf_fine, stage_trunks(r, rays, trunk)
    kw = dict(num_freqs=15, dirs_freqs=4)
    tile_zero = lambda w: (w.reshape(-1, 2, 4, 32) == 0).all(-1).all(1)
    with torch.no_grad():
        for fine in (False, True):
            mask = early_term_mask(stage_alpha_plain(mlp, rays, z,
                                                     int8=q8[fine], **kw), 1e-4)
            assert 0.1 < float(mask.float().mean()) < 0.9
            kept = ~mask.reshape(-1, 2, 4, 32)[:, 0, :, 0]
            a = render_stage(mlp, rays, z, fine=fine, early_term_eps=1e-4,
                             int8=q8[fine], **kw)["weights"]
            b = render_stage_plain(mlp, rays, z, fine=fine, early_term_eps=1e-4,
                                   int8=q8[fine], **kw)["weights"]
            assert bool((a[mask] == 0).all())
            assert torch.equal(tile_zero(a) & kept, tile_zero(b) & kept)


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [256, 512, 1024])
@pytest.mark.parametrize("trunk", ["bf16", "both", "posttap"])
def test_render_eval_is_deterministic(dev, trunk, hid):
    """Two launches of the kernel (fine stage, a bf16 trunk or the int8
    trunk of ``trunk``, tiles dying at different blocks, so the tile counter
    hands them out in another order) give the same bits."""
    r, rays, z = opaque_renderer(hid, dev, 2048)
    mlp, q8 = r.nerf_fine, stage_trunks(r, rays, trunk)
    kw = dict(fine=True, num_freqs=15, dirs_freqs=4, early_term_eps=1e-4,
              int8=q8[True])
    with torch.no_grad():
        a = render_stage(mlp, rays, z, **kw)
        b = render_stage(mlp, rays, z, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [256, 512, 1024])
@pytest.mark.parametrize("trunk", ["bf16", "both", "posttap"])
@pytest.mark.parametrize("n", ["3600", "one_extra_tile", "3_tiles"])
def test_render_eval_ragged_grids_match_plain(dev, n, trunk, hid):
    """Ray counts that leave a warpgroup without a tile: 3600 (a scene-point
    grid), 2 x (2 x SMs) + 2 (one tile beyond the first round) and 6 (a
    block with one tile); coarse and fine (a bf16 trunk, or the int8 trunk
    of ``trunk``) at eps 1e-4 against the plain version at 5e-3 scaled,
    every output finite.  At hid 512 a block takes one tile at a time, so
    the extra tile is a second round's."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {"3600": 3600, "one_extra_tile": 2 * (2 * sms) + 2, "3_tiles": 6}[n]
    r, rays, z = opaque_renderer(hid, dev, n)
    mlp, q8 = r.nerf_fine, stage_trunks(r, rays, trunk)
    kw = dict(num_freqs=15, dirs_freqs=4, early_term_eps=1e-4)
    with torch.no_grad():
        for fine in (False, True):
            a = render_stage(mlp, rays, z, fine=fine, int8=q8[fine], **kw)
            b = render_stage_plain(mlp, rays, z, fine=fine, int8=q8[fine], **kw)
            assert all(bool(torch.isfinite(v).all()) for v in a.values())
            assert scaled_max_err(a, b) < 5e-3, fine


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["bf16", "both", "posttap"])
@pytest.mark.parametrize("hid", [64, 256, 512, 1024])
def test_render_eval_tap_recompute_is_exact(dev, hid, trunk):
    """The fine stage runs the tap layer twice (the descriptor is composited
    once the weights are known; at hid 512 it reads back the values the
    tap layer's epilogue kept): the second pass's activations equal the
    first's bit for bit, the debug build's outputs equal the shipped
    build's within 5e-3 scaled; a bf16 trunk, and the int8 trunk of
    ``trunk`` (its tap layer s8 in 'both', bf16 in 'posttap')."""
    r, rays, z = opaque_renderer(hid, dev, 1024)
    mlp, q8 = r.nerf_fine, stage_trunks(r, rays, trunk)
    kw = dict(fine=True, num_freqs=15, dirs_freqs=4, early_term_eps=1e-4,
              int8=q8[True])
    with torch.no_grad():
        a = render_stage(mlp, rays, z, debug_tap=True, **kw)
        b = render_stage(mlp, rays, z, **kw)
    assert float(a["tap_first"].abs().max()) > 0
    assert torch.equal(a["tap_first"], a["tap_again"])
    assert scaled_max_err({k: a[k] for k in b}, b) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 256, 512, 1024])
@pytest.mark.parametrize("mode", ["coarse", "both", "posttap"])
def test_int8_render_kernel_matches_plain(dev, hid, mode):
    """The int8 trunk's stages of ``mode`` against the plain int8 version
    with the same scales (calibrated from these rays): outputs at atol/rtol
    5e-3 (the bf16 layers and heads, as above, and compositing order), and
    fewer than 1e-3 of the integer activations (the quantized encoding and
    the last layer's int8 input) one step apart (sinf / expf against
    torch's, and the bf16 prefix's f32 sums, at a rounding boundary; at hid
    512 :func:`int8_flips_held`); the launch counters of the int8 stages
    move."""
    from nerfmatch_tpu_torch.nerf.model import eval_feat_layer
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_mlp_int8)

    r = renderer(hid, dev)
    rays, z = rays_z(64, dev)
    scales = calibrate_act_scales(r, rays)
    tap = eval_feat_layer(r.nerf_fine.cfg)
    stages = [(r.nerf_coarse, False, pack_mlp_int8(r.nerf_coarse,
                                                   scales["coarse"], 0))]
    if mode != "coarse":
        start = 0 if mode == "both" else tap + 1
        stages.append((r.nerf_fine, True, pack_mlp_int8(
            r.nerf_fine, scales["fine"], start, tap)))
    reset_launch_counts()
    kw = dict(num_freqs=15, dirs_freqs=4, debug_q=True)
    with torch.no_grad():
        for mlp, fine, q in stages:
            a = render_stage(mlp, rays, z, fine=fine, int8=q, **kw)
            b = render_stage_plain(mlp, rays, z, fine=fine, int8=q, **kw)
            for k in ("xq", "hq"):
                assert int8_flips_held(a[k], b[k], hid), k
            for k in b:
                if k not in ("xq", "hq"):
                    torch.testing.assert_close(a[k], b[k], atol=5e-3,
                                               rtol=5e-3)
    assert LAUNCHES["render_coarse_int8"] == 1
    assert LAUNCHES["render_fine_int8"] == (mode != "coarse")
    assert LAUNCHES["render_coarse"] == LAUNCHES["render_fine"] == 0


def with_pnt_block(mlp, seed=0):
    """A copy of ``mlp`` with a scene-coordinate head (``out_3d_pnt``, 3
    channels, seeded), its trunk and heads shared."""
    import dataclasses

    dev = mlp.pts_linears[0].weight.device
    out = NerfMLP(dataclasses.replace(mlp.cfg, out_3d_pnt=True, out_add_ch=3))
    init_params_(out, torch.Generator().manual_seed(seed))
    out.load_state_dict(mlp.state_dict(), strict=False)
    return out.to(dev).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 256, 512, 1024])
def test_render_kernel_ignores_the_scene_coordinate_head(dev, hid):
    """An out_scr MLP through kernel 1 (bf16 trunk, both stages) and kernel
    1b (the int8 trunk of 'coarse' and 'both') gives bit for bit the
    outputs of the same MLP without its head: the kernels render the trunk
    and the heads only."""
    from nerfmatch_tpu_torch.nerf.model import eval_feat_layer
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_mlp_int8)

    r = renderer(hid, dev)
    rays, z = rays_z(64, dev)
    scales = calibrate_act_scales(r, rays)
    kw = dict(num_freqs=15, dirs_freqs=4, early_term_eps=1e-4)
    reset_launch_counts()
    with torch.no_grad():
        for mlp, fine, name in ((r.nerf_coarse, False, "coarse"),
                                (r.nerf_fine, True, "fine")):
            head = with_pnt_block(mlp)
            tap = eval_feat_layer(mlp.cfg) if fine else None
            for q in (None, pack_mlp_int8(mlp, scales[name], 0, tap)):
                qh = None if q is None else pack_mlp_int8(
                    head, scales[name], 0, tap)
                a = render_stage(head, rays, z, fine=fine, int8=qh, **kw)
                b = render_stage(mlp, rays, z, fine=fine, int8=q, **kw)
                for k in b:
                    assert torch.equal(a[k], b[k]), (name, q is None, k)
    assert LAUNCHES["render_coarse"] == LAUNCHES["render_fine"] == 2
    assert LAUNCHES["render_coarse_int8"] == LAUNCHES["render_fine_int8"] == 2


def with_app_columns(mlp, seed=0):
    """A copy of ``mlp`` with an appearance input: its views layer gains 16
    seeded columns (its other weights shared) -> (app MLP, seeded (2, 16)
    table)."""
    import dataclasses

    g = torch.Generator().manual_seed(seed)
    dev = mlp.views_linears[0].weight.device
    out = NerfMLP(dataclasses.replace(mlp.cfg, app_dim=16)).to(dev)
    state = dict(mlp.state_dict())
    wv = state["views_linears.0.weight"]
    state["views_linears.0.weight"] = torch.cat([wv, 0.1 * torch.randn(
        wv.shape[0], 16, generator=g).to(dev)], 1)
    out.load_state_dict(state, strict=True)
    return out.eval(), torch.randn(2, 16, generator=g).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["bf16", "both", "posttap"])
@pytest.mark.parametrize("hid", [64, 256, 512, 1024])
def test_render_kernel_with_app_matches_plain(dev, hid, trunk):
    """The fine stage of an appearance NeRF (a bf16 trunk, or the int8
    trunk of ``trunk``) on rays of both table rows, at eps 1e-4, against
    its plain version at 5e-3 scaled, counted as an ``_app`` launch; its
    weights, depth, acc, feat and pts bit-identical to the same MLP's stage
    without the appearance columns, and its rgb moved by the rows; the
    coarse stage ignores ``app``."""
    r, rays, z = opaque_renderer(hid, dev, 512)
    q8 = stage_trunks(r, rays, trunk)[True]
    mlp, table = with_app_columns(r.nerf_fine)
    ids = torch.arange(512, device=dev) % 2
    app = table[ids].contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4, early_term_eps=1e-4, int8=q8)
    reset_launch_counts()
    with torch.no_grad():
        a = render_stage(mlp, rays, z, fine=True, app=app, **kw)
        b = render_stage_plain(mlp, rays, z, fine=True, app=app, **kw)
        base = render_stage(r.nerf_fine, rays, z, fine=True, **kw)
        other = render_stage(mlp, rays, z, fine=True, app=table[1 - ids]
                             .contiguous(), **kw)
        coarse = render_stage(mlp, rays, z, fine=False, app=app, **kw)
        coarse0 = render_stage(r.nerf_fine, rays, z, fine=False, **kw)
    assert scaled_max_err(a, b) < 5e-3
    assert LAUNCHES["render_fine" + ("" if q8 is None else "_int8")
                    + "_app"] == 2           # the stages with app: a, other
    for k in ("weights", "depth", "acc", "feat", "pts"):
        assert torch.equal(a[k], base[k]), k
        assert torch.equal(a[k], other[k]), k
    assert float((a["rgb"] - base["rgb"]).abs().max()) > 1e-3
    assert float((a["rgb"] - other["rgb"]).abs().max()) > 1e-3
    for k in coarse0:
        assert torch.equal(coarse[k], coarse0[k]), k
    with pytest.raises(ValueError):
        render_stage(mlp, rays, z, fine=True, **kw)
    with pytest.raises(ValueError):
        render_stage(mlp, rays, z, fine=True, app=app[:, :8].contiguous(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["bf16", "posttap"])
@pytest.mark.parametrize("hid", [64, 256, 512, 1024])
def test_render_kernel_feat_max_matches_plain(dev, hid, trunk):
    """The fine stage with feat_max (the sample of each ray's largest
    weight; a bf16 trunk, or the int8 trunk of 'posttap') at eps 1e-4, tiles
    dying at different blocks, against ``render_stage_plain(feat_max=True)``:
    weights, depth, acc and rgb within 5e-3 scaled and bit-identical to the
    lin stage's; pts within 5e-3 and feat within 5e-3 of its largest value
    on the rays outside the tie margin (``feat_max_agreement``), and inside
    it a point within 5e-3 of a near-tied sample's; a rerun bit-identical;
    counted as a ``_max`` launch.  The coarse stage refuses feat_max."""
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        feat_max_agreement)

    r, rays, z = opaque_renderer(hid, dev, 2048)
    q8 = stage_trunks(r, rays, trunk)[True]
    mlp = r.nerf_fine
    kw = dict(fine=True, num_freqs=15, dirs_freqs=4, early_term_eps=1e-4,
              int8=q8)
    reset_launch_counts()
    with torch.no_grad():
        a = render_stage(mlp, rays, z, feat_max=True, **kw)
        again = render_stage(mlp, rays, z, feat_max=True, **kw)
        lin = render_stage(mlp, rays, z, **kw)
        b = render_stage_plain(mlp, rays, z, feat_max=True, **kw)
    for k in a:
        assert torch.equal(a[k], again[k]), k
    for k in ("weights", "depth", "acc", "rgb"):
        assert torch.equal(a[k], lin[k]), k
    assert scaled_max_err({k: a[k] for k in ("weights", "depth", "acc", "rgb")},
                          {k: b[k] for k in ("weights", "depth", "acc", "rgb")}) < 5e-3
    got = feat_max_agreement(a, b, rays, z)
    assert got["pts_err"] < 5e-3 and got["pick_err"] < 5e-3, got
    assert got["feat_err"] < 5e-3, got
    assert got["near_tie"] < 0.05 * rays.shape[0], got
    assert float((a["pts"] - lin["pts"]).abs().max()) > 1e-3
    assert LAUNCHES["render_fine" + ("" if q8 is None else "_int8")
                    + "_max"] == 2
    with pytest.raises(ValueError):
        render_stage(mlp, rays, z, fine=False, feat_max=True, num_freqs=15,
                     dirs_freqs=4)


@pytest.mark.cuda
def test_int8_render_kernel_raises_on_unsupported(dev):
    """A width above 1024 (no instantiation holds it), a trunk packed at
    another width than the kernel's (320, which runs at 512; 640, which
    runs at 1024), and a fine stage packed without its tap layer, raise
    instead of running plain."""
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_mlp_int8)

    padded = renderer(320, dev)
    rays, z = rays_z(64, dev)
    scales = calibrate_act_scales(padded, rays)
    with pytest.raises(ValueError, match="pack_kernel_int8"), torch.no_grad():
        render_stage(padded.nerf_coarse, rays, z, fine=False, num_freqs=15,
                     dirs_freqs=4,
                     int8=pack_mlp_int8(padded.nerf_coarse, scales["coarse"]))
    padded = renderer(640, dev)
    scales = calibrate_act_scales(padded, rays)
    with pytest.raises(ValueError, match="pack_kernel_int8"), torch.no_grad():
        render_stage(padded.nerf_coarse, rays, z, fine=False, num_freqs=15,
                     dirs_freqs=4,
                     int8=pack_mlp_int8(padded.nerf_coarse, scales["coarse"]))
    wide = renderer(1280, dev)
    rays, z = rays_z(64, dev)
    scales = calibrate_act_scales(wide, rays)
    with pytest.raises(NotImplementedError), torch.no_grad():
        render_stage(wide.nerf_coarse, rays, z, fine=False, num_freqs=15,
                     dirs_freqs=4,
                     int8=pack_mlp_int8(wide.nerf_coarse, scales["coarse"]))
    r = renderer(256, dev)
    scales = calibrate_act_scales(r, rays)
    with pytest.raises(ValueError), torch.no_grad():
        render_stage(r.nerf_fine, rays, z, fine=True, num_freqs=15,
                     dirs_freqs=4,
                     int8=pack_mlp_int8(r.nerf_fine, scales["fine"]))


@pytest.mark.cuda
def test_resample_kernel_matches_plain(dev):
    """Inverse-CDF resample at atol 1e-5, including an all-zero row."""
    rays, z = rays_z(256, dev)
    w = torch.rand(256, 128, device=dev, generator=torch.Generator(dev).manual_seed(0))
    w[3] = 0.0
    torch.testing.assert_close(resample_z(z, w), resample_z_plain(z, w),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_resample_kernel_stratified_u_matches_plain(dev):
    """The training mode: the caller's stratified u, atol 1e-5."""
    from nerfmatch_tpu_torch.nerf.sampling import stratified_u
    rays, z = rays_z(256, dev)
    g = torch.Generator(dev).manual_seed(1)
    w = torch.rand(256, 128, device=dev, generator=g)
    u = stratified_u(256, 129, g, dev)
    torch.testing.assert_close(resample_z(z, w, u=u),
                               resample_z_plain(z, w, u=u), atol=1e-5, rtol=0)


def resample_rows(n, nb, dev, even=True, seed=3):
    """Fenceposts (n, nb) and weights (n, nb - 1): normalised and raw
    exponential rows, all-zero, one-hot and near-one-hot rows in turn.
    ``even``: fenceposts evenly spaced between a near and a far plane, as
    the coarse pass makes them; else sorted uniform draws (bins up to ~8x
    wider than the mean: there the output moves by the bin's width over its
    pdf times the cdf's rounding, up to 1.3e-5 between two f32 summation
    orders at nb 33, and the plain version itself is 7.6e-6 off an f64
    reference)."""
    rng = np.random.default_rng(seed + nb)
    nw = nb - 1
    if even:
        near = rng.uniform(0.05, 0.3, (n, 1))
        far = rng.uniform(1.0, 2.1, (n, 1))
        z = (near + (far - near) * np.linspace(0, 1, nb)).astype(np.float32)
    else:
        z = np.sort(rng.uniform(0.05, 1.4, (n, nb)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(n, nw)).astype(np.float32)
    kind = np.arange(n) % 5
    w[kind == 0] /= w[kind == 0].sum(-1, keepdims=True) * 1.2
    w[kind == 2] = 0.0
    w[kind >= 3] = rng.uniform(0, 1e-6, ((kind >= 3).sum(), nw))
    hot = rng.integers(0, nw, n)
    w[kind == 3, hot[kind == 3]] = 1.0
    w[kind == 4, hot[kind == 4]] = 0.97
    return (torch.from_numpy(z).to(dev), torch.from_numpy(w).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("stratified", [False, True])
@pytest.mark.parametrize("nb", [2, 33, 65, 129, 257])
@pytest.mark.parametrize("n", [1, 7, 9216])
def test_resample_kernel_matches_scan_plain(dev, n, nb, stratified):
    """Against the plain version at 1e-5 (even fenceposts) and against the
    scan plain version (the kernel's summation order) at 1e-6 (even and
    uneven fenceposts); a rerun is bit-identical.  The plain version runs on
    the CPU copy, where its cumsum accumulates in f64: on the card its f32
    cumsum is itself up to 1.0e-5 off an f64 reference on these rows (the
    kernel 5.4e-6)."""
    from nerfmatch_tpu_torch.nerf.sampling import stratified_u
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z_scan_plain)
    u = (stratified_u(n, nb, torch.Generator(dev).manual_seed(nb), dev)
         if stratified else None)
    for even in (True, False):
        z, w = resample_rows(n, nb, dev, even)
        got = resample_z(z, w, u=u)
        if even:
            cpu = [None if t is None else t.cpu() for t in (z, w, u)]
            torch.testing.assert_close(got.cpu(), resample_z_plain(*cpu[:2],
                                                                   u=cpu[2]),
                                       atol=1e-5, rtol=0)
        torch.testing.assert_close(got, resample_z_scan_plain(z, w, u=u),
                                   atol=1e-6, rtol=0)
        assert torch.equal(got, resample_z(z, w, u=u))
        assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "coarse"])
def test_inerf_coarse_resample_matches_its_plain_twin(dev, mode):
    """``NerfRenderer.coarse_resample`` on the card, iNeRF's no-gradient
    half: one coarse stage and one resample a call, on 3601 rays (one
    padding ray) with non-unit directions (the depth rescale), against the
    same stage's plain version (bf16 or int8 trunk, eps 1e-4) and the plain
    resample: the fine fenceposts within 1e-4 on average, 2e-2 at most."""
    import dataclasses

    from nerfmatch_tpu_torch.nerf.renderer import reparam_unit_dir

    r = renderer(256, dev)
    with torch.no_grad():
        r.nerf_coarse.alpha_linear.bias += 3.0
    r.cfg = dataclasses.replace(r.cfg, trunk_int8=mode)
    rays, _ = rays_z(3601, dev)
    rays[:, 3:6] *= 1.3
    r._ensure_int8_calibrated(rays)
    packed = r.pack_fused()
    reset_launch_counts()
    with torch.no_grad():
        z = r.coarse_resample(rays, packed)
    assert LAUNCHES["render_coarse" + ("_int8" if mode != "none" else "")] == 1
    assert LAUNCHES["resample"] == 1 and LAUNCHES["render_fine"] == 0
    padded, nrm = reparam_unit_dir(torch.cat([rays, rays[-1:]]))
    t = torch.linspace(0, 1, 129, device=dev)
    z0 = padded[:, 6:7] * (1 - t) + padded[:, 7:8] * t
    with torch.no_grad():
        w = render_stage_plain(r.nerf_coarse, padded, z0, fine=False,
                               num_freqs=15, dirs_freqs=4, var_scale=1.0,
                               early_term_eps=r.cfg.early_term_eps,
                               int8=packed[0][1])["weights"]
    dz = (z - (resample_z_plain(z0, w) / nrm)[:3601]).abs()
    assert z.shape == (3601, 129)
    assert float(dz.mean()) < 1e-4 and float(dz.max()) < 2e-2, dz.max()


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 258])
def test_resample_kernel_refuses_bin_counts(dev, nb):
    z = torch.linspace(0, 1, nb, device=dev).expand(4, nb).contiguous()
    with pytest.raises(ValueError):
        resample_z(z, torch.ones(4, nb - 1, device=dev))


@pytest.mark.cuda
def test_resample_kernel_handles_misaligned_views(dev):
    """Weights, bins and u as contiguous views 4 bytes past a 16-byte
    boundary: the kernel takes them (scalar loads), and agrees with the
    float4 path on the same values bit for bit."""
    from nerfmatch_tpu_torch.nerf.sampling import stratified_u
    z, w = resample_rows(64, 129, dev)
    u = stratified_u(64, 129, torch.Generator(dev).manual_seed(0), dev)
    shifted = [torch.empty(t.numel() + 1, device=dev)[1:].view_as(t).copy_(t)
               for t in (z, w, u)]
    assert all(t.data_ptr() % 16 == 4 and t.is_contiguous() for t in shifted)
    for uu, su in ((None, None), (u, shifted[2])):
        got = resample_z(shifted[0], shifted[1], u=su)
        assert torch.equal(got, resample_z(z, w, u=uu))
        torch.testing.assert_close(got, resample_z_plain(z, w, u=uu),
                                   atol=1e-5, rtol=0)


def train_stage(hid, dev, n=64, S=128, seed=0, white_bg=False, app_dim=0):
    cfg = NerfConfig(layer_num=8, hid_dim=hid, xyz_dim=90, dirs_dim=27,
                     app_dim=app_dim, use_viewdirs=True, skips=(4,))
    mlp = init_params_(NerfMLP(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        mlp.alpha_linear.bias += 1.0
    mlp = mlp.to(dev)
    rays, _ = rays_z(n, dev, seed)
    g = torch.Generator(dev).manual_seed(seed)
    t = torch.linspace(0, 1, S + 1, device=dev)
    z = rays[:, 6:7] * (1 - t) + rays[:, 7:8] * t
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lo, hi = torch.cat([z[:, :1], mids], 1), torch.cat([mids, z[:, -1:]], 1)
    z = (lo + (hi - lo) * torch.rand(z.shape, device=dev, generator=g)).contiguous()
    noise = torch.randn(n, S, device=dev, generator=g)
    target = torch.rand(n, 3, device=dev, generator=g)
    return StageSpec(mlp, 15, 4, white_bg=white_bg), rays, z, noise, target


def stage_grads(fn, spec, rays, z, noise, target):
    spec.mlp.zero_grad()
    rgb, w = fn(spec, rays, z, noise)
    loss = ((rgb - target) ** 2).mean() + 0.1 * (w ** 2).mean()
    loss.backward()
    return rgb.detach(), w.detach(), {k: p.grad.clone() for k, p in
                                      spec.mlp.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("hid,S,white_bg", [
    (64, 128, False), (256, 128, False), (256, 64, False), (256, 256, False),
    (256, 128, True), (32, 128, False), (96, 128, False), (128, 128, False),
    (192, 128, False), (320, 128, False), (512, 128, False), (512, 64, False),
    (512, 256, True), (640, 128, False), (1024, 128, False), (1024, 256, True)])
def test_render_train_kernels_match_plain(dev, hid, S, white_bg):
    """Train forward (rgb, weights) at atol 5e-3 against the plain version
    with the same bf16 operands; backward per parameter: cosine > 0.999,
    norm ratio 1 +- 1e-2 and max error <= 3e-2 of the leaf's largest
    gradient (f32 sums in another order; the gradients are rounded to bf16
    on both sides); both launch counters move.  S = 64 puts two rays in one
    128-row chunk of the backward, S = 256 one ray in two; 320 runs at 512,
    padded, and 512 on its own engine (64-row chunks, a ray S / 64 of
    them); 640 runs at 1024, padded, and 1024 on the same engine in two N
    passes a layer."""
    spec, rays, z, noise, target = train_stage(hid, dev, S=S,
                                               white_bg=white_bg)
    reset_launch_counts()
    a_rgb, a_w, a_g = stage_grads(render_train, spec, rays, z, noise, target)
    b_rgb, b_w, b_g = stage_grads(render_train_plain, spec, rays, z, noise,
                                  target)
    assert LAUNCHES["render_train_fwd"] == LAUNCHES["render_train_bwd"] == 1
    torch.testing.assert_close(a_rgb, b_rgb, atol=5e-3, rtol=0)
    torch.testing.assert_close(a_w, b_w, atol=5e-3, rtol=0)
    for k, ref in b_g.items():
        got = a_g[k]
        assert torch.isfinite(got).all(), k
        nr = float(ref.norm())
        if nr < 1e-9:
            continue
        cos = float((got * ref).sum()) / (float(got.norm()) * nr)
        ratio = float(got.norm()) / nr
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert cos > 0.999 and abs(ratio - 1) < 1e-2 and err < 3e-2, \
            (k, cos, ratio, err)


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [32, 96, 128, 192, 320, 512, 640, 1024])
@pytest.mark.parametrize("mode", ["coarse", "posttap"])
def test_int8_render_kernel_at_every_width(dev, hid, mode):
    """The int8 stages at the widths the kernels take beside 64 and 256:
    the kernel on the trunk packed at its width (``pack_kernel_int8``: 32,
    96, 320 and 640 zero-padded to 64, 128, 512 and 1024, their padded
    columns at unit scale; at 512 and 1024 the s8 images unpermuted),
    the plain int8 version on the unpadded trunk with the same scales;
    tolerances of test_int8_render_kernel_matches_plain (outputs 5e-3,
    fewer than 1e-3 of the integer activations one step apart, at 512
    :func:`int8_flips_held`)."""
    from nerfmatch_tpu_torch.nerf.model import eval_feat_layer
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_kernel_int8,
                                                       pack_mlp_int8)

    r = renderer(hid, dev)
    rays, z = rays_z(64, dev)
    scales = calibrate_act_scales(r, rays)
    tap = eval_feat_layer(r.nerf_fine.cfg)
    name, mlp, fine, start, sc = (
        ("coarse", r.nerf_coarse, False, 0, scales["coarse"]) if mode == "coarse"
        else ("fine", r.nerf_fine, True, tap + 1, scales["fine"]))
    stap = tap if fine else None
    reset_launch_counts()
    kw = dict(num_freqs=15, dirs_freqs=4, debug_q=True, early_term_eps=1e-4)
    with torch.no_grad():
        a = render_stage(mlp, rays, z, fine=fine,
                         int8=pack_kernel_int8(mlp, sc, start, stap), **kw)
        b = render_stage_plain(mlp, rays, z, fine=fine,
                               int8=pack_mlp_int8(mlp, sc, start, stap), **kw)
    for k in ("xq", "hq"):
        assert a[k].shape == b[k].shape, k
        assert int8_flips_held(a[k], b[k], hid), k
    for k in b:
        if k not in ("xq", "hq"):
            assert a[k].shape == b[k].shape, k
            torch.testing.assert_close(a[k], b[k], atol=5e-3, rtol=5e-3)
    assert LAUNCHES[f"render_{name}_int8"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [96, 512, 1024])
def test_kernels_at_the_widest_encoding(dev, hid):
    """F = 21 (126 encoding columns) and Fd = 18 with an appearance table
    (111 + 16 extras columns), the JAX kernels' limits, hid 96, 512 and
    1024:
    kernel 1's fine stage with the appearance rows against its plain
    version (atol / rtol 5e-3, as test_render_kernel_matches_plain), and
    kernels 5 and 6 against the plain train stage
    (test_render_train_kernels_match_plain's tolerances), g_app included."""
    F, Fd, app_dim = 21, 18, 16
    cfg = NerfConfig(layer_num=8, hid_dim=hid, xyz_dim=6 * F, dirs_dim=6 * Fd + 3,
                     app_dim=app_dim, use_viewdirs=True, skips=(4,),
                     stop_layer=3)
    mlp = init_params_(NerfMLP(cfg), torch.Generator().manual_seed(4))
    with torch.no_grad():
        mlp.alpha_linear.bias += 3.0
    mlp = mlp.to(dev)
    rays, z = rays_z(64, dev)
    g = torch.Generator(dev).manual_seed(4)
    app = 0.5 * torch.randn(64, app_dim, device=dev, generator=g)
    reset_launch_counts()
    kw = dict(num_freqs=F, dirs_freqs=Fd, early_term_eps=1e-4)
    with torch.no_grad():
        a = render_stage(mlp, rays, z, fine=True, app=app, **kw)
        b = render_stage_plain(mlp, rays, z, fine=True, app=app, **kw)
    for k in b:
        torch.testing.assert_close(a[k], b[k], atol=5e-3, rtol=5e-3)
    assert LAUNCHES["render_fine_app"] == 1
    spec = StageSpec(mlp, F, Fd)
    noise = torch.randn(64, 128, device=dev, generator=g)
    target = torch.rand(64, 3, device=dev, generator=g)
    out = {}
    for fn in (render_train, render_train_plain):
        mlp.zero_grad()
        ap = app.clone().requires_grad_(True)
        rgb, w = fn(spec, rays, z, noise, ap)
        (((rgb - target) ** 2).mean() + 0.1 * (w ** 2).mean()).backward()
        out[fn] = (rgb.detach(), w.detach(), {
            **{k: p.grad.clone() for k, p in mlp.named_parameters()},
            "app": ap.grad})
    (a_rgb, a_w, a_g), (b_rgb, b_w, b_g) = out[render_train], out[
        render_train_plain]
    assert LAUNCHES["render_train_fwd_app"] == LAUNCHES["render_train_bwd_app"] == 1
    torch.testing.assert_close(a_rgb, b_rgb, atol=5e-3, rtol=0)
    torch.testing.assert_close(a_w, b_w, atol=5e-3, rtol=0)
    for k, ref in b_g.items():
        got = a_g[k]
        assert torch.isfinite(got).all(), k
        nr = float(ref.norm())
        if nr < 1e-9:
            continue
        cos = float((got * ref).sum()) / (float(got.norm()) * nr)
        ratio = float(got.norm()) / nr
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert cos > 0.999 and abs(ratio - 1) < 1e-2 and err < 3e-2, \
            (k, cos, ratio, err)


@pytest.mark.cuda
def test_render_train_kernels_are_deterministic(dev):
    """Two backward runs give bit-identical gradients (no atomics)."""
    spec, rays, z, noise, target = train_stage(256, dev, seed=3)
    _, _, g1 = stage_grads(render_train, spec, rays, z, noise, target)
    _, _, g2 = stage_grads(render_train, spec, rays, z, noise, target)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


@pytest.mark.cuda
def test_train_kernel_raises_on_unported_configs(dev):
    """Appearance rows of another width than 16, widths above 1024, odd ray
    counts and sample counts other than 64, 128 or 256 (S = 192 would leave
    the backward's last 64-row half of each ray out) raise instead of
    running plain; the C entries refuse S = 192 on their own too, and a
    launch at 1024 without the tile engine's scratch.  Width 128, refused
    before it was instantiated, runs; 1280 raises naming the ROADMAP in the
    train kernels as in the render kernel."""
    spec, rays, z, noise, _ = train_stage(64, dev, n=4, S=64)
    app8 = NerfMLP(NerfConfig(layer_num=8, hid_dim=64, xyz_dim=90, dirs_dim=27,
                              app_dim=8, use_viewdirs=True)).to(dev)
    cfg = lambda hid: NerfConfig(layer_num=8, hid_dim=hid, xyz_dim=90,
                                 dirs_dim=27, use_viewdirs=True)
    wide = NerfMLP(cfg(128)).to(dev)
    rgb, w = render_train(StageSpec(wide, 15, 4), rays, z, noise)
    assert torch.isfinite(rgb).all() and torch.isfinite(w).all()
    with pytest.raises(NotImplementedError):
        render_train(StageSpec(app8, 15, 4), rays, z, noise)
    too_wide = NerfMLP(cfg(1280)).to(dev)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2,"):
        render_train(StageSpec(too_wide, 15, 4), rays, z, noise)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2,"):
        render_stage(NerfMLP(cfg(1280)).to(dev), rays, z[:, :65].contiguous(),
                     fine=False, num_freqs=15, dirs_freqs=4)
    with pytest.raises(NotImplementedError):
        render_train(spec, rays[:3], z[:3], noise[:3])
    with pytest.raises(NotImplementedError):
        render_train(spec, rays, z[:, :33].contiguous(),
                     noise[:, :32].contiguous())
    spec192, rays192, z192, noise192, _ = train_stage(64, dev, n=4, S=192)
    with pytest.raises(NotImplementedError):
        render_train(spec192, rays192, z192, noise192)
    args = list(_kernel_args(spec, rays, z, noise, pack_train(spec.mlp)))
    args[6] = 192                                   # samples
    lib = kernels.library()
    assert lib.nm_render_train_forward(*args, None, None, None, None, 0,
                                       None) != 0
    assert lib.nm_render_train_backward(*args, None, None, None, None, None,
                                        None, None, None, 0, None) != 0
    # Width 1024 at a valid S, without the scratch: refused before a launch.
    spec1k, rays1k, z1k, noise1k, _ = train_stage(1024, dev, n=4, S=64)
    args = list(_kernel_args(spec1k, rays1k, z1k, noise1k,
                             pack_train(spec1k.mlp)))
    out = torch.empty(4, 64, device=dev)
    assert lib.nm_render_train_scratch(1024, 4) > 0
    assert lib.nm_render_train_scratch(512, 4) == 0
    assert lib.nm_render_train_forward(*args, out.data_ptr(), out.data_ptr(),
                                       None, None, 0, None) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("hid,S", [(64, 128), (256, 64), (256, 256),
                                   (1024, 128)])
def test_train_forward_with_stash_equals_forward_without(dev, hid, S):
    """The training forward (filling the stash) and the no-gradient forward
    give bit-identical rgb and weights; the stash is the size the C side
    and its Python mirror give."""
    spec, rays, z, noise, _ = train_stage(hid, dev, S=S)
    packed = pack_train(spec.mlp)
    rgb_a, w_a, st = kernel_forward(spec, rays, z, noise, packed, stash=True)
    rgb_b, w_b, none = kernel_forward(spec, rays, z, noise, packed)
    torch.cuda.synchronize()
    assert none is None and torch.isfinite(w_a).all()
    assert torch.equal(rgb_a, rgb_b) and torch.equal(w_a, w_b)
    n = rays.shape[0]
    assert st.numel() == _sizes(spec.mlp.cfg, n, S)[0]
    assert _sizes(spec.mlp.cfg, n, S)[:2] == workspace_bytes(spec.mlp.cfg, n, S)


@pytest.mark.cuda
def test_train_forward_without_gradient_allocates_no_stash(dev):
    """Under no_grad the kernel forward keeps nothing beyond its outputs;
    with a gradient the stash stays allocated until the backward has run,
    which frees it."""
    spec, rays, z, noise, target = train_stage(256, dev)
    n, S = z.shape[0], z.shape[1] - 1
    stash = _sizes(spec.mlp.cfg, n, S)[0]
    out = n * 3 * 4 + n * S * 4
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    with torch.no_grad():
        rgb, w = render_train(spec, rays, z, noise)
    assert torch.cuda.memory_allocated() - m0 <= out + 1024
    del rgb, w
    spec.mlp.zero_grad()
    m0 = torch.cuda.memory_allocated()
    rgb, w = render_train(spec, rays, z, noise)
    loss = ((rgb - target) ** 2).mean() + 0.1 * (w ** 2).mean()
    m1 = torch.cuda.memory_allocated()
    assert m1 - m0 >= stash
    loss.backward()
    torch.cuda.synchronize()
    grads = sum(p.grad.numel() * 4 for p in spec.mlp.parameters())
    assert torch.cuda.memory_allocated() <= m1 - stash + grads + (1 << 20)


@pytest.mark.cuda
def test_train_second_backward_raises(dev):
    """The backward consumes the stash: a second backward through the same
    graph raises instead of recomputing the forward."""
    spec, rays, z, noise, target = train_stage(64, dev, S=64)
    rgb, w = render_train(spec, rays, z, noise)
    loss = ((rgb - target) ** 2).mean() + 0.1 * (w ** 2).mean()
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="stash"):
        loss.backward()


@pytest.mark.cuda
def test_train_backward_without_parameter_gradients_returns_none(dev):
    """When only the rays ask for a gradient, the forward keeps no stash and
    the backward runs no kernel and gives the rays none, as the plain
    version does."""
    spec, rays, z, noise, target = train_stage(64, dev, S=64)
    spec.mlp.requires_grad_(False)
    for fn in (render_train, render_train_plain):
        r = rays.clone().requires_grad_(True)
        reset_launch_counts()
        rgb, w = fn(spec, r, z, noise)
        loss = ((rgb - target) ** 2).mean() + 0.1 * (w ** 2).mean()
        loss.backward()
        assert r.grad is None and LAUNCHES["render_train_bwd"] == 0
        assert all(p.grad is None for p in spec.mlp.parameters())


def app_rows(n, dev, seed=0):
    """(n, 16) appearance rows: two seeded N(0, 1) table rows, alternating."""
    table = torch.randn(2, 16, generator=torch.Generator().manual_seed(seed))
    return table[torch.arange(n) % 2].to(dev).contiguous()


def app_stage_grads(fn, spec, rays, z, noise, target, app):
    a = app.clone().requires_grad_(True)
    rgb, w, g = stage_grads(lambda *x: fn(*x, a), spec, rays, z, noise,
                            target)
    return rgb, w, {**g, "app": a.grad.clone()}


@pytest.mark.cuda
@pytest.mark.parametrize("hid,S", [(64, 128), (256, 128), (256, 64),
                                   (256, 256)])
def test_render_train_kernels_with_app_match_plain(dev, hid, S):
    """Kernels 5 and 6 of an appearance MLP (each ray's row into the views
    layer, ``g_app`` out of the backward): rgb and weights at atol 5e-3
    against the plain version with the same rows; every parameter gradient
    and ``g_app`` at cosine > 0.999, norm ratio 1 +- 1e-2 and max error <=
    3e-2 of its largest value; the ``_app`` counters move, the others do
    not; a second forward and backward give bit-identical outputs and
    gradients (no atomics); the rows move rgb."""
    spec, rays, z, noise, target = train_stage(hid, dev, S=S, app_dim=16)
    with torch.no_grad():
        spec.mlp.views_linears[0].weight[:, -16:] *= 4.0   # rows that matter
    app = app_rows(rays.shape[0], dev)
    reset_launch_counts()
    a_rgb, a_w, a_g = app_stage_grads(render_train, spec, rays, z, noise,
                                      target, app)
    assert LAUNCHES["render_train_fwd_app"] == LAUNCHES["render_train_bwd_app"] == 1
    assert LAUNCHES["render_train_fwd"] == LAUNCHES["render_train_bwd"] == 0
    again = app_stage_grads(render_train, spec, rays, z, noise, target, app)
    assert torch.equal(a_rgb, again[0]) and torch.equal(a_w, again[1])
    assert all(torch.equal(a_g[k], again[2][k]) for k in a_g)
    b_rgb, b_w, b_g = app_stage_grads(render_train_plain, spec, rays, z, noise,
                                      target, app)
    torch.testing.assert_close(a_rgb, b_rgb, atol=5e-3, rtol=0)
    torch.testing.assert_close(a_w, b_w, atol=5e-3, rtol=0)
    for k, ref in b_g.items():
        got = a_g[k]
        assert torch.isfinite(got).all(), k
        nr = float(ref.norm())
        if nr < 1e-9:
            continue
        cos = float((got * ref).sum()) / (float(got.norm()) * nr)
        ratio = float(got.norm()) / nr
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert cos > 0.999 and abs(ratio - 1) < 1e-2 and err < 3e-2, \
            (k, cos, ratio, err)
    with torch.no_grad():
        rgb0, _ = render_train(spec, rays, z, noise, torch.zeros_like(app))
    assert float((a_rgb - rgb0).abs().max()) > 1e-3


@pytest.mark.cuda
def test_render_train_backward_with_only_app_grad(dev):
    """Only the appearance rows ask for a gradient: the forward keeps its
    stash, the backward runs and returns ``g_app`` equal to that of a
    backward with every parameter, and no parameter gradient."""
    spec, rays, z, noise, target = train_stage(256, dev, S=64, app_dim=16)
    app = app_rows(rays.shape[0], dev, seed=1)
    _, _, full = app_stage_grads(render_train, spec, rays, z, noise, target,
                                 app)
    spec.mlp.zero_grad(set_to_none=True)
    spec.mlp.requires_grad_(False)
    a = app.clone().requires_grad_(True)
    reset_launch_counts()
    rgb, w = render_train(spec, rays, z, noise, a)
    (((rgb - target) ** 2).mean() + 0.1 * (w ** 2).mean()).backward()
    assert LAUNCHES["render_train_bwd_app"] == 1
    assert torch.equal(a.grad, full["app"])
    assert all(p.grad is None for p in spec.mlp.parameters())


@pytest.mark.cuda
def test_render_train_refuses_app_of_the_wrong_width(dev):
    """On CUDA tensors an appearance MLP takes app (N, 16) f32: rows of
    another width, none, or rows given to an MLP without the table's
    columns raise before any launch."""
    spec, rays, z, noise, _ = train_stage(64, dev, n=4, S=64, app_dim=16)
    plain, *_ = train_stage(64, dev, n=4, S=64)
    reset_launch_counts()
    for sp, rows in ((spec, app_rows(4, dev)[:, :8].contiguous()),
                     (spec, torch.zeros(4, 32, device=dev)),
                     (spec, None), (plain, app_rows(4, dev))):
        with pytest.raises(ValueError, match="app"):
            render_train(sp, rays, z, noise, rows)
    assert sum(LAUNCHES.values()) == 0


# (B, L, S, H): L != S and both ragged; S below one 64-key tile; S one past
# a tile boundary.
ATTN_SHAPES = [(2, 333, 517, 8), (1, 300, 20, 2), (2, 100, 129, 2)]
# head_dims: the four instantiations' widths, one that runs zero-filled at
# 16 (8), and one whose bf16 rows are not 16-byte multiples (33: cast into
# rows of 40, zero-filled to 64 on the card).
ATTN_HEAD_DIMS = [8, 16, 32, 33, 64, 128]


def attn_inputs(dev, shape, q_scale=0.3, d=32):
    """Seeded inputs, q scaled by q_scale sqrt(32 / d) (the callers'
    1 / sqrt(d))."""
    B, L, S, H = shape
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(B, L, H, d, device=dev, generator=g) * q_scale * (32 / d) ** 0.5
    k = torch.randn(B, S, H, d, device=dev, generator=g)
    v = torch.randn(B, S, H, d, device=dev, generator=g)
    up = torch.randn(B, L, H, d, device=dev, generator=g)
    return q, k, v, up


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(1, 3600, 14400, 8)])
@pytest.mark.parametrize("d", ATTN_HEAD_DIMS)
def test_attention_kernel_matches_plain(dev, bf16, shape, d):
    """Ragged L, S, and the merged multi-pair layout's S = 14,400 (past the
    JAX kernel's 8192 keys), at every head_dim of ``ATTN_HEAD_DIMS``.  f32
    (three TF32 passes): max and mean absolute 1e-5 against both plain
    versions, which one TF32 pass misses (``test_torch_attention_tf32``).
    bf16 mode: against
    the one-pass plain
    version, which rounds the same bf16 operands and the same
    probabilities 2^(x - ceil(max x)), mean 1e-5 and max 1e-3 (ex2.approx
    and the summation order break a few bf16 rounding ties apart); against
    the two-pass ``attention_plain``, whose probabilities exp(s - max)
    differ from the kernel's by no power of two and so round
    independently, every element within the bound of two such roundings
    (2^-7 of the softmax-weighted mean of |v|).  ``lse`` against
    ``torch.logsumexp`` to 1e-4; two runs bit-identical, with and without
    ``lse``.  At head_dims other than 32, whose inputs put more ties on
    peaked rows, each element against the one-pass version is held to the
    bound of one broken tie instead of 1e-3 (below)."""
    B, L, S, H = shape
    q, k, v, _ = attn_inputs(dev, shape, d=d)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    with torch.no_grad():
        out = fused_attention(q, k, v, bf16)
        qo, ko, vo = attention_kernel._operands((q, k, v), bf16)
        out2, lse, _ = attention_kernel._forward_kernel(qo, ko, vo, bf16,
                                                          True)
        err = (out - attention_plain(q, k, v, bf16)).abs()
        one, _ = attention_onepass_plain(q, k, v, bf16)
        err1 = (out - one).abs()
        want = torch.logsumexp(torch.einsum("blhd,bshd->bhls", rnd(q), rnd(k)),
                               -1).reshape(B * H, L)
        bound = 2.0 ** -7 * attention_plain(rnd(q), rnd(k), rnd(v).abs())
    assert torch.equal(out, out2) and torch.isfinite(out).all()
    assert float((lse - want).abs().max()) < 1e-4
    if bf16:
        assert float(err1.mean()) < 1e-5
        if d == 32:
            assert float(err1.max()) < 1e-3
        else:
            # A tie broken apart moves an element by one bf16 step of a
            # probability times its v: within 2^-7 of the softmax-weighted
            # mean of |v| (``bound``), however peaked the row (at head_dim
            # 33 and 64 on the 333 x 517 inputs single elements reach 1.9e-3
            # and 2.2e-3, 0.24 and 0.30 of that bound), and rarely.
            assert bool((err1 <= bound + 1e-6).all())
            assert float((err1 > 1e-4).float().mean()) < 1e-3
        assert bool((err <= bound + 1e-6).all())
    else:
        assert float(err.max()) < 1e-5 and float(err1.max()) < 1e-5
        assert float(err.mean()) < 1e-5 and float(err1.mean()) < 1e-5


@pytest.mark.cuda
def test_kernels_raise_instead_of_falling_back(dev):
    """Unsupported shapes and gradient requests raise on CUDA tensors."""
    r = renderer(256, dev)
    rays, z = rays_z(3, dev)
    with pytest.raises(NotImplementedError):
        render_stage(r.nerf_fine, rays, z, fine=True, num_freqs=15,
                     dirs_freqs=4)
    # head_dim 129: above the JAX kernel's 128, in both modes.
    q = torch.randn(1, 300, 2, 129, device=dev, requires_grad=True)
    for bf16 in (False, True):
        with pytest.raises(NotImplementedError):
            fused_attention(q, q.detach(), q.detach(), bf16)
        with pytest.raises(NotImplementedError):
            attention_bwd(q.detach(), q.detach(), q.detach(), q.detach(), bf16)
    one = torch.ones((), device=dev)
    # 96 channels (not a multiple of 128), then a 5 x 5 filter (7 x 7 only).
    for C, K in ((96, 7), (128, 5)):
        x = torch.randn(1, 16, 16, C, device=dev)
        w = torch.randn(K, K, C, device=dev)
        for fn in (lambda: dw_star(x, w, w[0, 0], one, one),
                   lambda: dw_star_dgrad(x, w, one, x),
                   lambda: dw_star_wgrad(x, one, one, x, K=K)):
            with pytest.raises(NotImplementedError):
                fn()


@pytest.mark.cuda
def test_dw_star_refuses_misaligned_inputs(dev):
    """Kernels 7, 8 and 9 read x, g and w through TMA tensor maps, whose
    base addresses must lie on 16-byte boundaries; views that do not (x, g
    and w one element into larger buffers) are copied into fresh buffers by
    the wrappers and launch, as the JAX ``dw_star`` takes any array: y, dx
    and dw within 1e-4 of the plain versions' largest values, ds and db
    within 1e-5 of the sum of the absolute terms (the tolerances of
    test_dw_star_kernels_match_plain), each kernel launched once."""
    B, H, W, C = 1, 16, 16, 128
    x0, w0, cb, s, b, g0 = sepconv_inputs(dev, B, H, W, C, seed=3)
    shift = lambda t: torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
    x, w, g = shift(x0), shift(w0), shift(g0)
    assert all(t.data_ptr() % 16 for t in (x, w, g))
    reset_launch_counts()
    assert scaled_err(dw_star_fwd(x, w, cb, s, b),
                      dw_star_plain(x0, w0, cb, s, b)) < 1e-4
    dx, ds, db = dw_star_dgrad(x, w, s, g)
    dxp, dsp, dbp = dw_star_dgrad_plain(x0, w0, s, g0)
    assert scaled_err(dx, dxp) < 1e-4
    wf = torch.flip(w0, (0, 1)).permute(2, 0, 1).unsqueeze(1)
    dact = torch.nn.functional.conv2d(g0.permute(0, 3, 1, 2), wf, padding=3,
                                      groups=C)
    r = torch.relu(x0).permute(0, 3, 1, 2)
    assert abs(float(ds - dsp)) < 1e-5 * float((dact * r * r).abs().sum())
    assert abs(float(db - dbp)) < 1e-5 * float(dact.abs().sum())
    assert scaled_err(dw_star_wgrad(x, s, b, g),
                      dw_star_wgrad_plain(x0, s, b, g0)) < 1e-4
    assert LAUNCHES["dw_star_fwd"] == LAUNCHES["dw_star_dgrad"] == \
        LAUNCHES["dw_star_wgrad"] == 1


@pytest.mark.cuda
def test_dw_star_dgrad_launches_the_grid_it_is_given(dev):
    """Kernel 8 launches one block per partials row it is given: any count
    in [1, tiles] gives the same dx, and its partials sum to the plain ds
    and db within 1e-5 of the sum of the absolute terms; a count outside
    that range is refused without a launch."""
    B, H, W, C = 1, 40, 40, 128          # 3 x 3 tiles x 4 channel groups
    tiles = 36
    x, w, _, s, _, g = sepconv_inputs(dev, B, H, W, C)
    dxp, dsp, dbp = dw_star_dgrad_plain(x, w, s, g)
    wf = torch.flip(w, (0, 1)).permute(2, 0, 1).unsqueeze(1)
    dact = torch.nn.functional.conv2d(g.permute(0, 3, 1, 2), wf, padding=3,
                                      groups=C)
    r = torch.relu(x).permute(0, 3, 1, 2)
    lib = kernels.library()

    def launch(parts):
        dx = torch.empty_like(x)
        part = torch.empty(max(parts, 1), 2, device=dev)
        err = lib.nm_dw_star_dgrad(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), s.data_ptr(),
            dx.data_ptr(), part.data_ptr(), parts, B, H, W, C, 7,
            kernels.stream_ptr(dev))
        return err, dx, part.sum(0)

    dxs = []
    for parts in (1, 5, tiles):
        err, dx, (ds, db) = launch(parts)
        assert err == 0
        assert scaled_err(dx, dxp) < 1e-4
        assert abs(float(ds - dsp)) < 1e-5 * float((dact * r * r).abs().sum())
        assert abs(float(db - dbp)) < 1e-5 * float(dact.abs().sum())
        dxs.append(dx)
    assert all(torch.equal(dx, dxs[0]) for dx in dxs)
    for parts in (0, tiles + 1):
        assert launch(parts)[0] != 0


@pytest.mark.cuda
def test_dw_star_wgrad_launches_the_grid_it_is_given(dev):
    """Kernel 9 launches one block per partials row it is given: any
    multiple of the channel groups in [groups, tiles] gives dw within 1e-4
    of the plain version's largest value, bit-identical on a rerun; a count
    outside that range is refused without a launch (dw stays untouched)."""
    B, H, W, C = 1, 40, 40, 128          # 3 x 3 tiles x 4 channel groups
    groups, tiles = 4, 36
    x, _, _, s, b, g = sepconv_inputs(dev, B, H, W, C)
    want = dw_star_wgrad_plain(x, s, b, g)
    lib = kernels.library()

    def launch(parts):
        dw = torch.full((7, 7, C), float("nan"), device=dev)
        part = torch.empty(max(parts, 1), 49, 32, device=dev)
        err = lib.nm_dw_star_wgrad(
            x.data_ptr(), g.data_ptr(), s.data_ptr(), b.data_ptr(),
            dw.data_ptr(), part.data_ptr(), parts, B, H, W, C, 7,
            kernels.stream_ptr(dev))
        torch.cuda.synchronize()
        return err, dw

    for parts in (groups, 3 * groups, tiles):
        err, dw = launch(parts)
        assert err == 0
        assert scaled_err(dw, want) < 1e-4
        assert torch.equal(launch(parts)[1], dw)
    for parts in (0, groups - 1, groups + 2, tiles + groups):
        err, dw = launch(parts)
        assert err != 0 and torch.isnan(dw).all()


@pytest.mark.cuda
def test_dw_star_wgrad_is_one_launch_with_small_partials(dev):
    """One wrapper call counts one launch of kernel 9 and, at stage 0 (B=2),
    allocates under 1 MB beside dw: one (49, 32) row of tap sums per block,
    not a (regions, 49, C) buffer (48 MB)."""
    x, _, _, s, b, g = sepconv_inputs(dev, 2, 240, 240, 256)
    dw_star_wgrad(x, s, b, g)            # builds; caches the grid
    torch.cuda.synchronize()
    reset_launch_counts()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dw = dw_star_wgrad(x, s, b, g)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - before - dw.numel() * 4
    assert LAUNCHES["dw_star_wgrad"] == 1 and sum(LAUNCHES.values()) == 1
    assert extra < 1 << 20, extra


def sepconv_inputs(dev, B, H, W, C, K=7, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(B, H, W, C, device=dev, generator=g)
    w = torch.randn(K, K, C, device=dev, generator=g) * 0.1
    cb = torch.randn(C, device=dev, generator=g)
    s = torch.tensor(0.9, device=dev)
    b = torch.tensor(-0.4, device=dev)
    up = torch.randn(B, H, W, C, device=dev, generator=g)
    return x, w, cb, s, b, up


def scaled_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 17, 9, 128), (2, 60, 60, 512),
                                   (2, 240, 240, 256), (1, 60, 60, 512),
                                   (1, 240, 240, 256), (2, 23, 7, 128),
                                   (1, 30, 30, 384)])
def test_dw_star_kernels_match_plain(dev, shape):
    """Forward, dgrad and wgrad against the plain versions (f32, TF32 off):
    y, dx and dw within 1e-4 of their largest value, ds and db within 1e-5
    of the sum of the absolute terms (f32 sums in another order).  Shapes:
    both trunk stages at batch 1 (serving) and 2 (training), H and W not
    multiples of the 16 x 16 tile with W at its minimum, three 128-channel
    groups."""
    x, w, cb, s, b, g = sepconv_inputs(dev, *shape)
    reset_launch_counts()
    assert scaled_err(dw_star_fwd(x, w, cb, s, b),
                      dw_star_plain(x, w, cb, s, b)) < 1e-4
    dx, ds, db = dw_star_dgrad(x, w, s, g)
    dxp, dsp, dbp = dw_star_dgrad_plain(x, w, s, g)
    assert scaled_err(dx, dxp) < 1e-4
    wf = torch.flip(w, (0, 1)).permute(2, 0, 1).unsqueeze(1)
    dact = torch.nn.functional.conv2d(g.permute(0, 3, 1, 2), wf, padding=3,
                                      groups=shape[-1])
    r = torch.relu(x).permute(0, 3, 1, 2)
    assert abs(float(ds - dsp)) < 1e-5 * float((dact * r * r).abs().sum())
    assert abs(float(db - dbp)) < 1e-5 * float(dact.abs().sum())
    assert scaled_err(dw_star_wgrad(x, s, b, g),
                      dw_star_wgrad_plain(x, s, b, g)) < 1e-4
    assert LAUNCHES["dw_star_fwd"] == LAUNCHES["dw_star_dgrad"] == \
        LAUNCHES["dw_star_wgrad"] == 1


@pytest.mark.cuda
def test_dw_star_autograd_matches_plain_and_is_deterministic(dev):
    """All five gradients of dw_star against autograd of the plain version,
    and two backward runs bit-identical (no atomics)."""
    x, w, cb, s, b, g = sepconv_inputs(dev, 2, 30, 30, 256, seed=2)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, w, cb, s, b)]
        (fn(*ins) * g).sum().backward()
        return [t.grad for t in ins]

    a1, a2, ref = grads(dw_star), grads(dw_star), grads(dw_star_plain)
    for got, again, want in zip(a1, a2, ref):
        assert torch.equal(got, again)
        assert scaled_err(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(2, 3600, 3600, 8)])
@pytest.mark.parametrize("d", ATTN_HEAD_DIMS)
def test_attention_bwd_kernel_matches_plain(dev, bf16, shape, d):
    """dq, dk, dv against the plain backward with the same roundings.  f32
    (three TF32 passes): 1e-5 of each output's largest value; bf16 (bf16
    operands, z and dl on
    both sides; rounding ties of z and dl broken apart by other summation
    orders, and the forward's rounding of e reaching delta = rowsum(g out)):
    1e-2 of the largest value and cosine > 0.999.  Two runs are
    bit-identical, and the autograd Function reaches the kernels: its
    forward hands ``out`` and ``lse`` over, the call on its own runs the
    forward kernel first, and both give the same bits.  Every head_dim of
    ``ATTN_HEAD_DIMS``."""
    q, k, v, up = attn_inputs(dev, shape, d=d)
    reset_launch_counts()
    with torch.no_grad():
        got = attention_bwd(q, k, v, up, bf16)
        again = attention_bwd(q, k, v, up, bf16)
        ref = attention_bwd_plain(q, k, v, up, bf16)
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2) and torch.isfinite(a).all()
        cos = float((a * r).sum()) / float(a.norm() * r.norm())
        assert scaled_err(a, r) < (1e-2 if bf16 else 1e-5) and cos > 0.999
    # Each call on its own launched the forward kernel and the backward.
    assert LAUNCHES["attention_bwd"] == 2 and LAUNCHES["attention"] == 2
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (fused_attention(*leaves, bf16) * up).sum().backward()
    for leaf, want in zip(leaves, got):
        assert torch.equal(leaf.grad, want)
    assert LAUNCHES["attention_bwd"] == 3 and LAUNCHES["attention"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("L,S", [(3600, 14400), (14400, 14400)])
def test_attention_backward_merged_matches_plain(dev, L, S):
    """The bf16 backward at merged multi-pair training's shapes (B = 2, H =
    8: the image's queries over 14,400 points, and the points' self
    attention), as the training path calls it (the forward's ``out`` and
    ``lse`` handed over), against the plain backward taken a head at a time
    (its logits of all heads would not fit): 1e-2 of each output's largest
    value and cosine > 0.999; a rerun is bit-identical."""
    q, k, v, up = attn_inputs(dev, (2, L, S, 8))
    with torch.no_grad():
        qo, ko, vo = attention_kernel._operands((q, k, v), True)
        out, lse, _ = attention_kernel._forward_kernel(qo, ko, vo, True, True)
        got = attention_bwd(qo, ko, vo, up, True, out=out, lse=lse)
        again = attention_bwd(qo, ko, vo, up, True, out=out, lse=lse)
        ref = [torch.empty_like(a) for a in got]
        for h in range(q.shape[2]):
            one = attention_bwd_plain(*(x[:, :, h:h + 1] for x in (q, k, v, up)),
                                      True)
            for r, o in zip(ref, one):
                r[:, :, h:h + 1] = o
            del one
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2) and torch.isfinite(a).all()
        cos = float((a * r).sum()) / float(a.norm() * r.norm())
        assert scaled_err(a, r) < 1e-2 and cos > 0.999, (scaled_err(a, r), cos)


@pytest.mark.cuda
def test_attention_f32_backward_at_14400_keys(dev):
    """The f32-mode backward (three TF32 passes) at the merged multi-pair
    layout's S = 14,400 (B = 2, H = 8, L = 3600), the forward's ``out`` and
    ``lse`` handed over, against the plain f32 backward taken a head at a
    time: 1e-5 of each output's largest value; a rerun is bit-identical."""
    q, k, v, up = attn_inputs(dev, (2, 3600, 14400, 8))
    with torch.no_grad():
        out, lse, ops = attention_kernel._forward_kernel(q, k, v, False, True)
        got = attention_bwd(*ops, up, False, out=out, lse=lse)
        again = attention_bwd(*ops, up, False, out=out, lse=lse)
        ref = [torch.empty_like(a) for a in got]
        for h in range(q.shape[2]):
            one = attention_bwd_plain(*(x[:, :, h:h + 1] for x in (q, k, v, up)))
            for r, o in zip(ref, one):
                r[:, :, h:h + 1] = o
            del one
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2) and torch.isfinite(a).all()
        assert scaled_err(a, r) < 1e-5, scaled_err(a, r)


def device_kernels(fn):
    """Names of the device kernels ``fn()`` launches (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 8, 16])
def test_attention_pads_narrow_heads(dev, D):
    """A head_dim below 32 (the e2e matcher's 64-wide coarse features: 8
    heads of 8, at L = S = 256) runs the 16-wide kernels with nothing padded
    in device memory: the forward is the cast launch and the kernel, the
    backward the prologue, dK/dV and dQ, and no other device kernel runs
    (no pad, no slice copy); the bf16 forward within 1e-3 (mean 1e-5) of
    the one-pass plain version and the backward through autograd within
    1e-2 of each gradient's largest value (cosine > 0.999) of the plain
    backward, each pass launching its kernel once."""
    g = torch.Generator(dev).manual_seed(0)
    q, k, v, up = (torch.randn(2, 256, 8, D, device=dev, generator=g) * s
                   for s in (0.3, 1.0, 1.0, 1.0))
    reset_launch_counts()
    with torch.no_grad():
        names = device_kernels(lambda: fused_attention(q, k, v, True))
        out = fused_attention(q, k, v, True)
        one, _ = attention_onepass_plain(q, k, v, True)
    assert len(names) == 2 and all("attention" in n for n in names), names
    assert out.shape == q.shape and LAUNCHES["attention"] == 2
    err = (out - one).abs()
    assert float(err.max()) < 1e-3 and float(err.mean()) < 1e-5
    reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (fused_attention(*leaves, True) * up).sum().backward()
    assert LAUNCHES["attention"] == 1 and LAUNCHES["attention_bwd"] == 1
    with torch.no_grad():
        qo, ko, vo = attention_kernel._operands((q, k, v), True)
        out, lse, ops = attention_kernel._forward_kernel(qo, ko, vo, True, True)
        names = device_kernels(
            lambda: attention_bwd(*ops, up, True, out=out, lse=lse))
    assert len(names) == 3 and all("attn_bwd" in n for n in names), names
    with torch.no_grad():
        ref = attention_bwd_plain(q, k, v, up, True)
    for leaf, r in zip(leaves, ref):
        a = leaf.grad
        cos = float((a * r).sum()) / float(a.norm() * r.norm())
        assert scaled_err(a, r) < 1e-2 and cos > 0.999, (scaled_err(a, r), cos)


@pytest.mark.cuda
def test_attention_forward_skips_lse_without_a_gradient(dev):
    """Under ``no_grad`` (serving) the autograd Function saves nothing and
    asks the kernel for no ``lse``; with a gradient it saves the bf16
    operands, the output and ``lse``."""
    q, k, v, _ = attn_inputs(dev, ATTN_SHAPES[0])
    with torch.no_grad():
        out = fused_attention(q, k, v, True)
    assert out.grad_fn is None
    out = fused_attention(q.requires_grad_(), k, v, True)
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16] * 3 + [torch.float32] * 2
    assert saved[4].shape == (q.shape[0] * q.shape[2], q.shape[1])


def test_ctypes_signatures_match_c_entry_points():
    """The ctypes argtypes table agrees with every ``extern "C"`` entry of
    csrc/*.cu, argument by argument (runs without a GPU)."""
    ctype = {"void*": kernels._P, "int": kernels._I, "float": kernels._F}
    found = {}
    for src in kernels.CSRC.glob("*.cu"):
        text = Path(src).read_text()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for arg in args.split(","):
                arg = re.sub(r"\bconst\b", "", arg).split()
                base = "void*" if "*" in "".join(arg) else arg[0]
                types.append(ctype[base])
            found[name] = types
    assert found == kernels._SIGNATURES
