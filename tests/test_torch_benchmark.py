"""The localization benchmark of the port against the JAX package on the
CPU: the pose summaries and the reference's result-file tag on fixed
inputs, and ``benchmark_nerfmatch --iters 2`` on a tiny synthetic scene
(one NeRF with its scene points cached by the port, a c2f matcher; the same
exported weights on both sides) against the JAX CLI."""

import itertools
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from nerfmatch_tpu.cli import benchmark_nerfmatch as jcli
from nerfmatch_tpu.config import dict2namespace
from nerfmatch_tpu.eval.match_evaluator import NeRFMatchEvaluator as JEvaluator
from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JC2FConfig
from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JNeRFMatcherMS
from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer
from nerfmatch_tpu.train.checkpoint import export_torch_state_dict
from nerfmatch_tpu.utils import metrics as jmetrics

from nerfmatch_tpu_torch.cli import benchmark_nerfmatch as tcli
from nerfmatch_tpu_torch.config import namespace2dict
from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.train.checkpoint import (save_checkpoint,
                                                  state_dict_from_jax)
from nerfmatch_tpu_torch.utils import metrics as tmetrics

from _synthetic import H, W, build_scene
from test_torch_models import TINY_C2F, flat_params
from test_torch_nerf import nerf_config

torch.set_num_threads(2)
HID = 32


def errors(seed, n=40):
    rng = np.random.default_rng(seed)
    r = rng.gamma(1.5, 2.0, n)
    t = rng.gamma(1.5, 0.03, n)
    r[::7], t[::7] = np.inf, np.inf                 # failed PnP
    return dict(R_err=r, t_err=t, num_matches=rng.integers(0, 300, n),
                match_time=rng.uniform(0.01, 0.05, n),
                localize_time=rng.uniform(0.05, 0.2, n))


@pytest.mark.parametrize("scene,seed", [("chess", 0), ("KingsCollege", 1),
                                        ("room", 2)])
def test_pose_summaries_match_jax(scene, seed):
    """summarize_pose_statis (median, recall at the scene's DSAC*
    threshold, AUC, times) and average_pose_metrics equal the JAX
    package's."""
    assert tmetrics.POSE_THRES == jmetrics.POSE_THRES
    kw = dict(pose_thres=tmetrics.POSE_THRES.get(scene, [(5, 5)]),
              t_unit="cm", t_scale=1e2, print_out=False)
    ours = [tmetrics.summarize_pose_statis(errors(seed + i), **kw)
            for i in range(3)]
    ref = [jmetrics.summarize_pose_statis(errors(seed + i), **kw)
           for i in range(3)]
    assert ours == ref
    assert tmetrics.average_pose_metrics(ours, print_out=False) == \
        jmetrics.average_pose_metrics(ref, print_out=False)
    e = errors(seed)
    np.testing.assert_array_equal(
        tmetrics.cal_error_auc(e["t_err"][:10], [1, 5]),
        jmetrics.cal_error_auc(e["t_err"][:10], [1, 5]))
    np.testing.assert_array_equal(
        tmetrics.compute_mean_recall([e["R_err"], e["t_err"]], [1, 5]),
        jmetrics.compute_mean_recall([e["R_err"], e["t_err"]], [1, 5]))


TAG_CASES = list(itertools.product([False, True], [True, False], [0.0, 0.2],
                                   ["colmap", "cv"], [1, 2]))


@pytest.mark.parametrize("coarse_only,mutual,thres,solver,iters", TAG_CASES)
def test_cache_tag_matches_jax(tmp_path, coarse_only, mutual, thres, solver,
                               iters):
    """The result file's name, tag by tag, as the JAX evaluator writes it."""
    stub = Namespace(cache_dir=tmp_path, coarse_only=coarse_only)
    dataset = Namespace(scene="chess")
    for extra in ({}, {"center_subpixel": True, "cache_iters": True},
                  {"debug": True}):
        args = dict(dataset=dataset, split="test", rthres=10.0, mutual=mutual,
                    match_thres=thres, solver=solver, center_subpixel=False,
                    retrieval_only=False, inerf_conf=None, iters=iters,
                    conf=Namespace(dataset="NeRFMatchPair"),
                    test_pair_txt=None, cached_pt=True, query2query=False,
                    cache_iters=False, match_oracle=False, debug=False)
        args.update(extra)
        assert NeRFMatchEvaluator._cache_tag(stub, **args) == \
            JEvaluator._cache_tag(stub, **args)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A 12-frame 64x64 scene; a tiny NeRF (hid 32) whose port render caches
    the scene points under an ``inter_layer3`` tag; a c2f matcher on 32-d
    points.  The JAX side gets reference-format ``.ckpt`` files
    (``export_torch_state_dict``), the port the same matcher file and a port
    checkpoint of the same NeRF."""
    root = tmp_path_factory.mktemp("bench")
    build_scene(root)
    ncfg = nerf_config(hid=HID)
    ncfg.data = dict2namespace({
        "dataset": "NerfBaseDataset", "data_dir": str(root), "scene": "toy",
        "img_wh": [W, H], "ray_type": "mip", "max_frustum_depth": 1,
        "rescale_factor": 1.0, "snorm_type": "fst", "downsample": 8})
    ncfg.exp = dict2namespace({"seed": 0})
    ncfg.downsample = 8
    ncfg.coarse_nerf.num_pts = ncfg.fine_nerf.num_pts = 32
    del ncfg.render.trunk_int8                     # the shipped configs' way
    nparams = JaxRenderer(ncfg, stop_layer=3).init_params(
        jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        nparams[k]["alpha_linear"]["bias"] = nparams[k]["alpha_linear"]["bias"] + 3.0
    tr = NerfRenderer(ncfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(nparams)), strict=True)
    scene_dir = NerfEvaluator(ncfg, tr).cache_scene_pts(
        cache_dir=root / "inter_layer3" / "toy")
    nerf_port = save_checkpoint(root / "nerf" / "checkpoints", 1, tr,
                                config=namespace2dict(ncfg), name="last")
    nerf_jax = root / "nerf" / "nerf.ckpt"
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in
                               export_torch_state_dict(nparams).items()},
                "hyper_parameters": vars(ncfg)}, nerf_jax)

    model = dict(TINY_C2F, pt_dim=HID)
    mconf = dict2namespace({
        "exp": {"seed": 0},
        "data": {"dataset": "NeRFMatchPair", "data_dir": str(root),
                 "scenes": ["toy"], "scene_dir": str(scene_dir),
                 "train_pair_txt": str(root / "pairs.txt"),
                 "test_pair_txt": str(root / "pairs.txt"), "pair_topk": 1,
                 "img_wh": [W, H], "model_ds": 8, "imagenet_norm": False,
                 "balanced_pair": False},
        "model": model})
    mparams = JNeRFMatcherMS(JC2FConfig(**model)).init_params(
        jax.random.PRNGKey(1))
    state = {k: torch.as_tensor(v) for k, v in export_torch_state_dict(
        mparams, backbone_extra="model.").items()}
    ckpts = {}
    for side in ("jax", "port"):
        (root / side).mkdir()
        ckpts[side] = root / side / "c2f.ckpt"
        torch.save({"state_dict": state, "hyper_parameters": vars(mconf)},
                   ckpts[side])
    return dict(root=root, ckpts=ckpts, nerf={"jax": nerf_jax,
                                              "port": nerf_port})


def test_benchmark_cli_matches_jax(bench):
    """``benchmark_nerfmatch --iters 2 --mutual --eval_bs 2`` on both
    packages: the result file of the reference's tag name on each side,
    equal per-query match counts, and per-query pose errors within the
    localization slice test's tolerances (1e-2 deg, 1e-3; PnP on the same
    matches, renders that agree to float rounding), with the int8 mode
    resolved to 'coarse' on the port's re-render NeRF (its CPU render stays
    f32, as the JAX XLA fallback's)."""
    flags = ["--iters", "2", "--mutual", "--rthres", "200", "--eval_bs", "2"]
    jcli.benchmark(jcli.build_parser().parse_args(
        ["--ckpts", str(bench["ckpts"]["jax"]), "--nerf_path",
         str(bench["nerf"]["jax"]), *flags]))
    results = tcli.main(["--ckpts", str(bench["ckpts"]["port"]),
                         "--nerf_path", str(bench["nerf"]["port"]),
                         "--device", "cpu", *flags])
    name = "toy_rth200test_colmap_itr2.npy"
    ref = np.load(bench["root"] / "jax" / "best_tmed_results" / name,
                  allow_pickle=True).item()
    ours = np.load(bench["root"] / "port" / "best_tmed_results" / name,
                   allow_pickle=True).item()
    assert len(ours["num_matches"]) == 12
    np.testing.assert_array_equal(ours["num_matches"], ref["num_matches"])
    assert (np.asarray(ours["num_matches"]) >= 6).all()
    for k, atol in (("R_err", 1e-2), ("t_err", 1e-3)):
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=atol, err_msg=k)
    assert {"match_time", "localize_time"} <= set(ours)
    (avg, per_scene), = results
    assert set(avg) == {"t_med", "r_med", "recall", "match_time",
                        "localize_time"}
    assert avg["t_med"] == pytest.approx(np.median(ours["t_err"]) * 100)


def test_benchmark_resolves_serving_int8_and_raises_unported(bench,
                                                             monkeypatch):
    """The re-render NeRF is loaded with ``serving=True`` (absent key ->
    'coarse'); flags of protocols that are not ported raise instead of being
    ignored."""
    from nerfmatch_tpu_torch.eval import match_evaluator as tme

    seen = []
    real = tme.load_nerf_render_from_ckpt

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        seen.append(r.cfg.trunk_int8)
        return r

    monkeypatch.setattr(tme, "load_nerf_render_from_ckpt", spy)
    base = ["--ckpts", str(bench["ckpts"]["port"]), "--nerf_path",
            str(bench["nerf"]["port"]), "--device", "cpu", "--iters", "2",
            "--mutual", "--rthres", "200", "--ow_cache", "--debug"]
    tcli.main(base)
    assert seen == ["coarse"]
    for flag in (["--inerf"], ["--pair_topk", "3"], ["--match_oracle"],
                 ["--retrieval_only"], ["--query2query"], ["--visualize"],
                 ["--no_cache_pt"], ["--point_shard"]):
        with pytest.raises(NotImplementedError):
            tcli.main(base + flag)


def test_parse_nerf_stop_layer_and_device_default(bench, monkeypatch):
    """The feature tap from the scene dir's tag; the evaluator and the CLI
    run on the card unless asked for the CPU, and raise without one."""
    from nerfmatch_tpu_torch.eval.match_evaluator import (
        load_nerfmatch_from_ckpt, parse_nerf_stop_layer)

    assert parse_nerf_stop_layer(
        "out/7scenes/inter_layer3/chess/mip/last_15ep/ds8lin") == 3
    assert parse_nerf_stop_layer(Path("/tmp/x/scene/toy/ds8lin")) == -1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_nerfmatch_from_ckpt(bench["ckpts"]["port"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--ckpts", str(bench["ckpts"]["port"])])
