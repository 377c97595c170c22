"""The reference protocol on Lightning checkpoints of the port's own trained
modules (counterpart of ``scripts/make_synthetic_parity_artifacts.py`` and
the ``--synthetic`` branch of ``scripts/run_real_parity.sh:42-100``).

:func:`make_artifacts` trains on the enclosed synthetic scene (a NeRF, its
ds-8 scene points, Mini, Full warm-started from Mini's ``best``) and writes
reference-format Lightning checkpoints of them: ``state_dict`` under the
reference's key names with the ``model.`` prefix (Full's trunk under
``backbone.model.*``, the two-scale wrapper's layout), ``hyper_parameters``
the training config, laid out as the benchmark CLI globs them::

    <root>/pretrained/nerf/toy/synth_last.ckpt
    <root>/pretrained/nerfmatch/7scenes_synth/toy/synth_{mini,full}.ckpt

:func:`protocol_steps` then runs the protocol's steps 2-5 through the port's
CLIs in this process: ``eval_nerf`` PSNR, ``eval_nerf --cache_scene_pts``,
Mini ``benchmark_nerfmatch --coarse_only --mutual --solver cv2 --rthres 10
--iters 2`` and Full ``--mutual --solver colmap --rthres 5 --iters 2``
(:func:`protocol_argv` gives their arguments, so the JAX CLIs can run the
same steps on the same files).

    python -m nerfmatch_tpu_torch.e2e.parity_artifacts --root DIR
        [--nerf_epochs 30] [--match_epochs 40] [--device cuda] [--out FILE]
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..cli import benchmark_nerfmatch, eval_nerf
from ..utils import resolve_device
from . import pipeline
from .scene import DS, H, W, build_scene

SCENE = "toy"


def save_lightning_ckpt(path, module, hparams, step):
    """A reference-format Lightning checkpoint of ``module`` (its state
    dict already carries the reference key names) -> ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({
        "state_dict": {"model." + k: v.detach().cpu()
                       for k, v in module.state_dict().items()},
        "hyper_parameters": dict(vars(hparams)),
        "epoch": step, "global_step": step,
    }, path)
    return path


def artifact_paths(root):
    root = Path(root)
    match_dir = root / "pretrained" / "nerfmatch" / "7scenes_synth"
    return {"nerf": root / "pretrained" / "nerf" / SCENE / "synth_last.ckpt",
            "match_dir": match_dir,
            "mini": match_dir / SCENE / "synth_mini.ckpt",
            "full": match_dir / SCENE / "synth_full.ckpt"}


def make_artifacts(root, nerf_epochs=30, match_epochs=40, device="cuda",
                   nerf_edits=None, matcher_edits=None):
    """Train on the enclosed scene under ``root`` and write the three
    checkpoints -> dict of their paths, the training cache dir, Full's warm
    start and the stage times."""
    device = resolve_device(device)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    build_scene(root, enclosed=True)
    paths = artifact_paths(root)
    times = {}
    t0 = time.perf_counter()
    ncfg, nerf = pipeline.train_nerf_stage(
        root, nerf_epochs, frustum_depth=pipeline.ENCLOSED_FRUSTUM_DEPTH,
        device=device, edits=nerf_edits)
    save_lightning_ckpt(paths["nerf"], nerf, ncfg, nerf_epochs)
    times["nerf"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cache_dir, _ = pipeline.cache_stage(
        root, nerf, frustum_depth=pipeline.ENCLOSED_FRUSTUM_DEPTH,
        device=device, edits=nerf_edits)
    times["cache"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    matchers = pipeline.train_matchers(root, cache_dir, match_epochs, device,
                                       edits=matcher_edits)
    for name, key in (("mini", "mini"), ("full", "full")):
        cfg, model = matchers[key]
        save_lightning_ckpt(paths[name], model, cfg, match_epochs)
    times["matchers"] = time.perf_counter() - t0
    return {**{k: str(v) for k, v in paths.items()},
            "train_cache": str(cache_dir),
            "warm_start": matchers["warm_start"], "seconds": times}


def protocol_argv(root, paths, out=None, img_wh=(W, H), psnr_frames=-1):
    """The arguments of the protocol's steps 2-5 (the CLIs' ``main``; no
    ``--device``): dict(psnr, cache, mini, full).  ``out``: the outputs'
    root (default ``<root>/outputs``); ``psnr_frames``: ``--nums``."""
    root = Path(root)
    out = Path(out) if out else root / "outputs"
    anno = str(root / SCENE / "transforms_#split.json")
    scene_pts = out / "scene_pts" / "inter_layer3" / SCENE
    wh = [str(x) for x in img_wh]
    bench = ["--ckpt_dir", str(paths["match_dir"]), "--scene", SCENE,
             "--split", "test", "--scene_dir", str(scene_pts / f"ds{DS}lin"),
             "--nerf_path", str(paths["nerf"]), "--mutual", "--iters", "2"]
    return {
        "psnr": ["--ckpt", str(paths["nerf"]), "--scene_anno_path", anno,
                 "--split", "test", "--img_wh", *wh, "--nums",
                 str(psnr_frames), "--cache_dir", str(out / "psnr")],
        "cache": ["--ckpt", str(paths["nerf"]), "--scene_anno_path", anno,
                  "--cache_scene_pts", "--downsample", str(DS),
                  "--stop_layer", "3", "--feat_comb", "lin", "--cache_dir",
                  str(scene_pts)],
        "mini": [*bench, "--model_name", "mini", "--coarse_only", "--solver",
                 "cv2", "--rthres", "10"],
        "full": [*bench, "--model_name", "full", "--solver", "colmap",
                 "--rthres", "5"],
    }


def bench_results(match_dir, model_name):
    """The benchmark's per-query file of ``model_name`` -> its dict."""
    files = sorted((Path(match_dir) / SCENE / f"{model_name}_results")
                   .glob(f"{SCENE}_*.npy"))
    if len(files) != 1:
        raise FileNotFoundError(f"expected one result file of {model_name}, "
                                f"found {files}")
    return np.load(files[0], allow_pickle=True).item()


def protocol_steps(root, paths, device="cuda", **kw):
    """Steps 2-5 through the port's CLIs -> dict(psnr, and for mini / full
    the benchmark's averages: t_med (cm), r_med (deg), recall (%, 5 cm /
    5 deg), and the per-query R_err, t_err, num_matches)."""
    argv = protocol_argv(root, paths, **kw)
    dev = ["--device", str(device)]
    times = {}
    t0 = time.perf_counter()
    psnr = eval_nerf.main(argv["psnr"] + dev)["psnr"]
    times["psnr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eval_nerf.main(argv["cache"] + dev)
    times["cache"] = time.perf_counter() - t0
    out = {"psnr": float(np.mean(psnr)), "psnr_frames": len(psnr)}
    for name in ("mini", "full"):
        t0 = time.perf_counter()
        (avg, _), = benchmark_nerfmatch.main(argv[name] + dev)
        times[name] = time.perf_counter() - t0
        per = bench_results(paths["match_dir"], name)
        out[name] = {**{k: float(avg[k]) for k in ("t_med", "r_med",
                                                   "recall")},
                     **{k: [float(x) for x in per[k]]
                        for k in ("R_err", "t_err", "num_matches")}}
    out["seconds"] = times
    return out


def main(argv=None):
    p = pipeline.build_parser(__doc__.splitlines()[0])
    p.add_argument("--nerf_epochs", type=int, default=30)
    p.add_argument("--match_epochs", type=int, default=40)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    made = make_artifacts(args.root, args.nerf_epochs, args.match_epochs,
                          args.device)
    steps = protocol_steps(args.root, artifact_paths(args.root), args.device)
    return pipeline.write_summary(
        {"artifacts": made, "protocol": steps,
         "nerf_epochs": args.nerf_epochs, "match_epochs": args.match_epochs,
         "seconds": time.perf_counter() - t0}, args.out)


if __name__ == "__main__":
    main()
