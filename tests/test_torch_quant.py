"""The int8 serving trunk of the port against the JAX package on the CPU:
activation-scale calibration, the int8 weight packing (rows, and the
weights unpacked from the render kernel's s8 slot images), the row order
of those images, the two-stage fused render in every
int8 mode (the port's plain versions against ``make_fused_hierarchical``
in interpret mode), and the serving paths' resolution of the int8 mode.

Same seeded rays and the same weights (JAX params through the weight
bridge) on both sides, at HID 64; tolerances are stated per test.
"""

import dataclasses
import json
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.nerf import renderer as jrenderer
from nerfmatch_tpu.ops.pallas import quant as jquant
from nerfmatch_tpu.ops.pallas.render_kernel import make_fused_hierarchical

from nerfmatch_tpu_torch.nerf import renderer as trenderer
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.ops.kernels import quant as tquant
from nerfmatch_tpu_torch.models.layers import init_params_
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (mlp_plain,
                                                           render_stage_plain)

from test_torch_nerf import (PI, make_rays, nerf_config, pair, t,  # noqa: F401
                             unslot_s8)

torch.set_num_threads(2)
MODES = ("coarse", "both", "posttap")


def to_torch_scales(scales):
    return {s: {"enc": t(v["enc"]), "acts": [t(a) for a in v["acts"]]}
            for s, v in scales.items()}


@pytest.fixture(scope="module")
def calib(pair):
    """The JAX scales of a seeded calibration batch, and the batch."""
    jr, params, tr = pair
    rays = make_rays(64, 11, nonunit=True)
    return rays, jquant.calibrate_act_scales(jr, params, jnp.asarray(rays))


def test_calibrate_act_scales_matches_jax(pair, calib):
    """Per-channel abs-max of the encoding and of every trunk layer, both
    stages (the fine stage sampled from the f32 coarse weights): rtol 1e-4,
    and for a nearly dead channel (its abs-max a few thousandths of the
    layer's) 1e-4 of the layer's largest scale, since the f32 products sum
    in another order on the two sides."""
    jr, params, tr = pair
    rays, ref = calib
    ours = tquant.calibrate_act_scales(tr, t(rays))
    for stage in ("coarse", "fine"):
        np.testing.assert_allclose(ours[stage]["enc"].numpy(),
                                   ref[stage]["enc"], rtol=1e-4)
        assert len(ours[stage]["acts"]) == len(ref[stage]["acts"])
        for a, b in zip(ours[stage]["acts"], ref[stage]["acts"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-4 * float(np.max(b)))


def unpack_images(q, layer_num):
    """pack_mlp_int8's s8 slot images (``img``) split by matrix and
    unpacked, PI undone for the hidden rows where the width permutes them
    (``quant.s8_rows_permuted``): {w{i}q | w{i}sq: (K, N)}."""
    out, off = {}, 0
    for i in range(q["start"], layer_num):
        for k in (f"w{i}q", f"w{i}sq"):
            if k in q:
                K, N = q[k].shape
                n = -(-K // 64) * 64 * N
                out[k] = unslot_s8(q["img"][off:off + n], K, N,
                                   permute=tquant.s8_rows_permuted(N)
                                   and i > 0 and k == f"w{i}q")
                off += n
    assert off == q["img"].numel()
    return out


def _int8_equal(ours, ref):
    """int8 weights equal, except at most 1 LSB on < 0.1% of the entries."""
    d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("mode", MODES)
def test_pack_mlp_int8_matches_jax(pair, calib, mode):
    """Every row (qenc, qh, c, B, s, b, iq: rtol 1e-6) and int8 weight
    (unpacked from the kernel's s8 slot images) of pack_mlp_int8 against
    pack_mlp_weights_int8, for both stages of the mode; the encoding rows
    are padded to 96 here and to 128 in JAX, with zero weights and scale 1
    on the padded lanes on both sides."""
    jr, params, tr = pair
    _, scales = calib
    _, jpack = make_fused_hierarchical(jr, interpret=True, trunk_int8=mode,
                                       act_scales=scales)
    jstages = jpack(params)
    tr.cfg = dataclasses.replace(tr.cfg, trunk_int8=mode)
    tr.act_scales = to_torch_scales(scales)
    ours = tr.pack_fused()
    for (_, q), jw, (name, _) in zip(ours, jstages, tr._stages()):
        if q is None:
            assert name == "fine" and mode == "coarse"
            assert not any(k.endswith("q") for k in jw)
            continue
        keys = [k for k in q if k not in ("start", "tap", "img")]
        assert keys and set(keys) <= set(jw), set(keys) - set(jw)
        assert not any(k.endswith("q") and k not in q for k in jw)
        unpacked = unpack_images(q, tr.fine_cfg.layer_num)
        assert set(unpacked) == {k for k in keys if k.startswith("w")}
        for k in keys:
            ref, got = np.asarray(jw[k]), q[k].numpy()
            if k.startswith("w"):
                assert torch.equal(unpacked[k], q[k]), k
                rows = min(got.shape[0], ref.shape[0])
                _int8_equal(got[:rows], ref[:rows])
                assert not ref[rows:].any() and not got[90:].any() \
                    if got.shape[0] == 96 else True
            else:   # (1, n) rows; the JAX last-layer bias is (n,)
                got, ref = got.reshape(-1), ref.reshape(-1)
                np.testing.assert_allclose(got, ref[:got.size], rtol=1e-6,
                                           err_msg=k)


@pytest.mark.parametrize("hid", [64, 256])
@pytest.mark.parametrize("mode", MODES)
def test_int8_slot_images_hold_the_weights(hid, mode):
    """The s8 slot images pack_mlp_int8 gives for the render kernel (per
    int8 layer its hidden rows, then its encoding rows) unpack, PI undone,
    to its w{i}q / w{i}sq exactly, at both kernel widths (a seeded random
    MLP, scales calibrated on 16 rays)."""
    tr = init_params_(NerfRenderer(nerf_config(hid=hid), stop_layer=3),
                      torch.Generator().manual_seed(hid)).eval()
    sc = tquant.calibrate_act_scales(tr, t(make_rays(16, 5)))["fine"]
    q = tquant.pack_mlp_int8(tr.nerf_fine, sc, 4 if mode == "posttap" else 0,
                             None if mode == "coarse" else 3)
    unpacked = unpack_images(q, tr.fine_cfg.layer_num)
    assert set(unpacked) == {k for k in q if k[0] == "w"}
    for k, w in unpacked.items():
        assert w.abs().max() > 0 and torch.equal(w, q[k]), k


@pytest.mark.parametrize("mode", ["coarse", "both"])
def test_int8_stage_is_unchanged_by_the_pi_order(pair, calib, mode):
    """The order the s8 images keep (PI in each 32-column block): with every
    hidden layer's output columns (weights, scale, bias and tap rows) and
    the next layer's hidden rows permuted by it, the plain int8 MLP gives
    the same integer activations, permuted, and the same sigma, rgb and
    tap (permuted) bit for bit: integer products in f32 are exact in any
    order."""
    jr, params, tr = pair
    _, scales = calib
    mlp, L, hid = tr.nerf_fine, tr.fine_cfg.layer_num, tr.fine_cfg.hid_dim
    perm = torch.from_numpy(np.arange(hid) // 32 * 32 + PI[np.arange(hid) % 32])
    tap = 3 if mode == "both" else None
    q = tquant.pack_mlp_int8(mlp, to_torch_scales(scales)["fine"], 0, tap)
    qp = dict(q)
    for i in range(L - 1):
        for k in (f"w{i}q", f"w{i}sq", f"c{i}", f"c{i}s", f"B{i}", f"iq{i}"):
            if k in qp:
                qp[k] = qp[k][:, perm]
        qp[f"w{i + 1}q"] = qp[f"w{i + 1}q"][perm]
    rng = np.random.default_rng(6)
    enc = t(rng.uniform(-1, 1, size=(16, 5, mlp.cfg.xyz_dim)))
    dirs = t(rng.normal(size=(16, 1, mlp.cfg.dirs_dim)))
    d0, d1 = {}, {}
    with torch.no_grad():
        a = mlp_plain(mlp, enc, dirs, -1 if tap is None else tap, True,
                      int8=q, debug=d0)
        b = mlp_plain(mlp, enc, dirs, -1 if tap is None else tap, True,
                      int8=qp, debug=d1)
    assert torch.equal(d0["xq"], d1["xq"])
    assert torch.equal(d0["hq"][..., perm], d1["hq"])
    assert not torch.equal(d0["hq"], d1["hq"])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if tap is not None:
        assert torch.equal(a[2][..., perm], b[2])


@pytest.mark.parametrize("mode", MODES)
def test_fused_render_int8_matches_pallas(pair, calib, mode):
    """fused_render through the plain int8 stages against
    make_fused_hierarchical(interpret=True, trunk_int8=mode) with the same
    scales.  The Pallas encoding uses _fast_sin/_fast_exp, so a few
    encoding quantizations sit a step apart: the bf16 fused test's 2e-2 on
    rgb/depth/pts and 0.1 relative on features; 'coarse' (the fine stage
    bf16 on both sides) within 5e-3 and 2e-2 relative."""
    jr, params, tr = pair
    rays, scales = calib
    rays = rays[:16]
    render, pack = make_fused_hierarchical(jr, interpret=True, ray_tile=8,
                                           trunk_int8=mode, act_scales=scales)
    ref = render(*pack(params), jnp.asarray(rays))
    tq = NerfRenderer(nerf_config(early_term_eps=0.0, trunk_int8=mode),
                      stop_layer=3)
    tq.load_state_dict(tr.state_dict())
    tq.act_scales = to_torch_scales(scales)
    with torch.no_grad():
        ours = tq.fused_render(t(rays))
    atol, frel = (5e-3, 2e-2) if mode == "coarse" else (2e-2, 0.1)
    for k in ("rgb_fine", "depth_fine", "pts_fine", "depth_coarse", "acc_fine"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=atol,
                                   err_msg=k)
    f_ref = np.asarray(ref["feat_fine"])
    f_rel = np.abs(ours["feat_fine"].numpy() - f_ref).max() / np.abs(f_ref).max()
    assert f_rel < frel, f_rel


def test_int8_stage_plain_is_exact_integer_arithmetic(pair, calib):
    """The plain int8 stage's integer activations are integers in
    [-127, 127] (hidden ones in [0, 127]); posttap's bf16 prefix leaves the
    encoding quantization unchanged; a tap at the last layer never
    quantizes the fine stage ('posttap' degenerates to 'coarse')."""
    jr, params, tr = pair
    rays, scales = calib
    r = t(rays[:8])
    tt = torch.linspace(0, 1, 129)
    z = r[:, 6:7] * (1 - tt) + r[:, 7:8] * tt
    sc = to_torch_scales(scales)["fine"]
    outs = []
    for start in (0, 4):
        q = tquant.pack_mlp_int8(tr.nerf_fine, sc, start, 3)
        outs.append(render_stage_plain(tr.nerf_fine, r, z, fine=True,
                                       num_freqs=15, dirs_freqs=4, int8=q,
                                       debug_q=True))
    for o in outs:
        assert o["xq"].dtype == torch.int8 and o["hq"].min() >= 0
        assert int(o["xq"].abs().max()) <= 127 and int(o["xq"].abs().max()) > 64
    assert torch.equal(outs[0]["xq"], outs[1]["xq"])
    last = NerfRenderer(nerf_config(trunk_int8="posttap"), stop_layer=-1)
    assert last.int8_plan() == (0, None)
    with pytest.raises(ValueError):
        tquant.pack_mlp_int8(tr.nerf_fine, sc, 3, 3)


def test_serving_int8_mode_matches_jax():
    """An absent key resolves to the serving default 'coarse'; an explicit
    mode, 'none' included, wins."""
    assert trenderer.SERVING_INT8_DEFAULT == jrenderer.SERVING_INT8_DEFAULT
    for render in ({}, {"trunk_int8": "none"}, {"trunk_int8": "coarse"},
                   {"trunk_int8": "posttap"}):
        cfg = Namespace(render=Namespace(**render))
        assert trenderer.serving_int8_mode(cfg) == \
            jrenderer.serving_int8_mode(cfg)
    assert trenderer.serving_int8_mode(Namespace()) == "coarse"


def _serving_config(root, trunk_int8):
    from nerfmatch_tpu.config import dict2namespace

    cfg = nerf_config()
    if trunk_int8 is None:
        del cfg.render.trunk_int8
    else:
        cfg.render.trunk_int8 = trunk_int8
    cfg.data = dict2namespace({
        "dataset": "NerfBaseDataset", "data_dir": str(root), "scene": "toy",
        "img_wh": [16, 16], "ray_type": "mip", "max_frustum_depth": 1,
        "rescale_factor": 1.0, "snorm_type": "fst", "downsample": 8})
    cfg.exp = dict2namespace({"seed": 0})
    cfg.downsample = 8
    return cfg


@pytest.fixture(scope="module")
def toy_scene(tmp_path_factory):
    """Two 16x16 frames in the dataset layout."""
    from PIL import Image

    root = tmp_path_factory.mktemp("serving")
    (root / "toy" / "seq").mkdir(parents=True)
    frames = []
    for i in range(2):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0.0, -0.3]
        name = f"seq/frame-{i:03d}.color.png"
        Image.fromarray(np.full((16, 16, 3), 40 * i + 20, np.uint8)).save(
            root / "toy" / name)
        frames.append(dict(file_path=name, height=16, width=16,
                           intrinsics=[[20, 0, 8], [0, 20, 8], [0, 0, 1]],
                           transform_matrix=c2w.tolist()))
    for split in ("train", "test"):
        (root / "toy" / f"transforms_{split}.json").write_text(
            json.dumps({"frames": frames}))
    return root


@pytest.mark.parametrize("trunk_int8", [None, "none", "coarse"])
def test_serving_paths_resolve_like_jax(pair, toy_scene, tmp_path,
                                        monkeypatch, trunk_int8):
    """cache_scene_pts() and load_nerf_render_from_ckpt(serving=True) leave
    the renderer at the mode the JAX functions serve on their fused path
    (absent -> 'coarse'), and the re-render NeRF carries the scene's
    unnorm matrix; the JAX renders are stubbed, only the resolution is
    compared."""
    from nerfmatch_tpu.eval import nerf_evaluator as jne
    from nerfmatch_tpu_torch.config import namespace2dict
    from nerfmatch_tpu_torch.eval.nerf_evaluator import (
        NerfEvaluator, load_nerf_render_from_ckpt)
    from nerfmatch_tpu_torch.train.checkpoint import save_checkpoint

    jr, params, tr = pair
    cfg = _serving_config(toy_scene, trunk_int8)
    jr = jrenderer.NerfRenderer(cfg, stop_layer=3)
    jr.fused_interpret = True             # the JAX fused path serves
    n = 4

    def fake_predict(params, rays, w=None, h=None, **kw):
        return {"pts_fine": np.zeros((n, 3), np.float32),
                "feat_fine": np.zeros((n, 64), np.float32),
                "rgb_fine": np.zeros((n, 3), np.float32)}

    monkeypatch.setattr(jr, "predict", fake_predict)
    jne.NerfEvaluator(cfg, jr, params).cache_scene_pts(cache_dir=tmp_path / "j")
    ours = NerfRenderer(cfg, stop_layer=3)
    ours.load_state_dict(tr.state_dict())
    NerfEvaluator(cfg, ours).cache_scene_pts(cache_dir=tmp_path / "t")
    want = jr.cfg.trunk_int8
    assert want == ("coarse" if trunk_int8 is None else trunk_int8)
    assert ours.cfg.trunk_int8 == want

    ckpt = save_checkpoint(tmp_path / "ckpts", 1, ours,
                           config=namespace2dict(cfg), name="last")
    def fused_renderer(*args, **kwargs):
        r = jrenderer.NerfRenderer(cfg, stop_layer=3)
        r.fused_interpret = True          # the JAX fused path serves
        return r, params, cfg

    monkeypatch.setattr(jne, "load_renderer_params", fused_renderer)
    jr2, _ = jne.load_nerf_render_from_ckpt(ckpt, serving=True)
    served = load_nerf_render_from_ckpt(ckpt, stop_layer=3, serving=True,
                                        device="cpu")
    assert served.cfg.trunk_int8 == jr2.cfg.trunk_int8 == want
    np.testing.assert_allclose(served.unnorm_scene, jr2.unnorm_scene,
                               atol=1e-6)
    plain = load_nerf_render_from_ckpt(ckpt, stop_layer=3, device="cpu")
    assert plain.cfg.trunk_int8 == (trunk_int8 or "none")
