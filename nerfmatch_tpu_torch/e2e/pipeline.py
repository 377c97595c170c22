"""The whole pipeline on the synthetic scene (counterpart of
``scripts/e2e_full_pipeline_tpu.py:183-367``), through the port's
production code paths:

1. train a production-width mip NeRF (``nerf_trainer.train``: kernels 5, 6
   and 2 on the card; appearance rows under ``cambridge``), and score its
   held-out views (PSNR);
2. cache the ds-8 layer-3 scene points of every frame
   (``NerfEvaluator.cache_scene_pts``: kernels 1b, 2 and 1 at an int8
   serving mode, 2 and 1 at ``'none'``);
3. train Mini (``train_coarse``), take its ``best`` checkpoint, and train
   Full warm-started from it through ``model.coarse_ckpt`` (``train_c2f``;
   kernels 3 and 4, and 7-9 for a trunk whose widths pass their gate);
4. localize the held-out queries under ``single``, ``c2f-fine``,
   ``iters2`` and ``iters2+inerf`` (``cambridge``: ``single``,
   ``c2f-fine`` and ``multipair``).

:func:`run` returns a summary dict (stage times, PSNR, per protocol the
medians, match counts, recall at ``R_THRES``, ``T_THRES`` and the
per-query errors); ``main`` prints it as JSON.

    python -m nerfmatch_tpu_torch.e2e.pipeline --root DIR [--enclosed]
        [--cambridge] [--nerf_epochs 10] [--match_epochs 40]
        [--device cuda] [--out FILE]

``nerf_config`` pins ``render.trunk_int8: 'none'`` and
``data.max_frustum_depth: 1`` as the JAX script does, ``--enclosed``
included (its pose numbers are compared across runs).  :func:`run`'s
``trunk_int8`` sets the serving mode of the cache and the re-render,
``backbone`` the matcher trunk (the JAX script's ``'tiny'`` trunk is too
narrow for the StarReLU + depthwise-conv kernels' gate, C % 128 == 0),
and ``frustum_depth`` the sampled depth (the ladder's, the gates' and the
parity artifacts' ``ENCLOSED_FRUSTUM_DEPTH``).
"""

from __future__ import annotations

import argparse
import json
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

from ..config import dict2namespace
from ..data.loaders import _collate
from ..data.match_dataset import NeRFMatchMultiPair, NeRFMatchPair
from ..eval.match_evaluator import NeRFMatchEvaluator
from ..eval.nerf_evaluator import NerfEvaluator
from ..nerf.renderer import NerfRenderer
from ..train import nerf_trainer
from ..train.checkpoint import latest_checkpoint
from ..train.matcher_trainer import (build_matcher, init_config_odir,
                                     load_pretrained, train_c2f, train_coarse)
from ..utils import resolve_device
from .scene import CAM_R, DS, H, W, build_scene

R_THRES, T_THRES = 5.0, 0.05    # recall thresholds (deg, scene units)
FEAT_LAYER = 3
# The ladder's, gates' and parity artifacts' depth: the shell (r 3.2)
# inside the sampled range.  The pipeline keeps the config's 1.
ENCLOSED_FRUSTUM_DEPTH = 6


def nerf_config(root, odir, epochs=10, app=False):
    return dict2namespace({
        "data": {"dataset": "NerfBaseDataset", "data_dir": str(root),
                 "scene": "toy", "img_wh": [W, H], "ray_type": "mip",
                 "max_frustum_depth": 1, "rescale_factor": 1.0,
                 "snorm_type": "fst"},
        "optim": {"optimizer": "adam", "lr": 2e-3, "weight_decay": 0.0,
                  "lr_scheduler": "cosine"},
        "coarse_nerf": {"method": "NeRF", "layer_num": 8, "hid_dim": 256,
                        "output_dim": 4, "skips": [4], "num_pts": 128},
        "fine_nerf": {"method": "NeRF", "layer_num": 8, "hid_dim": 256,
                      "output_dim": 4, "skips": [4], "num_pts": 128},
        "embedding": {"xyz_num_freqs": 15, "dirs_num_freqs": 4,
                      "type": "mip", "appearance_embed": app},
        "render": {"chunksize": 16384, "use_viewdirs": True,
                   "use_disp": False, "perturb": True, "white_bg": False,
                   "noise_std": 1.0, "use_fused_train": True,
                   # Pinned: the pose numbers are compared across runs; the
                   # int8 gate sets it per arm.
                   "trunk_int8": "none"},
        "loss": {"ray_reg_weight": 0.01},
        "exp": {"seed": 1, "odir": str(odir), "prefix": "e2e",
                "num_workers": 2, "max_epochs": epochs, "check_epochs": 2,
                "batch_size": 9216, "gpus": 1, "log_num_max": 1,
                "log_step": 20},
    })


def matcher_cfg(root, cache_dir, odir, epochs=40, c2f=False,
                multipair=False):
    return dict2namespace({
        "data": {"dataset": ("NeRFMatchMultiPair" if multipair
                             else "NeRFMatchPair"), "data_dir": str(root),
                 "scenes": ["toy"], "scene": "toy",
                 "scene_dir": str(cache_dir),
                 "train_pair_txt": str(Path(root) / "pairs_train.txt"),
                 "test_pair_txt": str(Path(root) / "pairs_test.txt"),
                 "pair_topk": 2, "img_wh": [W, H], "model_ds": DS,
                 "imagenet_norm": False, "balanced_pair": False},
        "model": {"backbone": "tiny", "pretrained": False, "cfeat_dim": 64,
                  "pt_dim": 256, "im_pe": True, "im_sa": 1,
                  "im_sa_type": "share", "pt_sa": 1, "pt_sa_type": "full",
                  "pt_pe": True, "coarse_layers": 1, "temp_type": "mul",
                  "rthres": 6,
                  # Full: 5x5 windows of the 1/2-scale map and dsnt
                  # subpixel regression on top of the coarse matches.
                  **({"ffeat_dim": 32, "fine_sa": 1, "fsa_type": "full",
                      "win_sz": 5, "cat_c_feat": True,
                      "fine_loss": "match", "coarse_percent": 0.3,
                      "coarse_dthres": 20} if c2f else {})},
        "optim": {"optimizer": "adam", "adapt_lr": True, "clr": 2e-3,
                  "cbs": 4, "weight_decay": 0.0, "lr_scheduler": "cosine"},
        "exp": {"seed": 2, "odir": str(odir), "prefix": "e2e",
                "num_workers": 2, "max_epochs": epochs, "check_epochs": 1,
                "batch_size": 2, "gpus": 1},
        "split": "test",
        "ckpt": "eval",
    })


def apply_edits(cfg, edits=None):
    """Set ``{"section.key": value}`` entries of a config namespace (the
    tests' small widths and budgets) -> ``cfg``."""
    for key, value in (edits or {}).items():
        *path, last = key.split(".")
        node = cfg
        for name in path:
            node = getattr(node, name)
        setattr(node, last, value)
    return cfg


def set_frustum_depth(cfg, depth=None):
    """``cfg`` with ``data.max_frustum_depth`` set where ``depth`` is given
    (None: the config's 1)."""
    if depth is not None:
        cfg.data.max_frustum_depth = depth
    return cfg


def serving_config(root, app=False, frustum_depth=None, split="test",
                   trunk_int8=None, early_term_eps=None, edits=None):
    """The NeRF config of the evaluation stages: ``split`` on the ds-8 grid
    (``'val'``: the held-out views at full size), with the frustum depth,
    serving mode and early-termination threshold set where given."""
    cfg = set_frustum_depth(apply_edits(
        nerf_config(root, Path(root) / "out_nerf", app=app), edits),
        frustum_depth)
    cfg.split = split
    if split == "test":
        cfg.downsample = cfg.data.downsample = DS
    cfg.ckpt = "eval"
    if trunk_int8 is not None:
        cfg.render.trunk_int8 = trunk_int8
    if early_term_eps is not None:
        cfg.render.early_term_eps = early_term_eps
    return cfg


def eval_renderer(cfg, trained, device, stop_layer=FEAT_LAYER,
                  cls=NerfRenderer):
    """A renderer of ``cfg`` (``stop_layer``: the feature tap) holding the
    trained weights, on ``device`` in eval mode."""
    table = getattr(trained, "embedding_a", None)
    r = cls(cfg, num_frames=None if table is None else table.weight.shape[0],
            stop_layer=stop_layer)
    r.load_state_dict(trained.state_dict(), strict=True)
    return r.to(device).eval()


def train_nerf_stage(root, epochs, app=False, frustum_depth=None,
                     device="cuda", edits=None):
    """Stage 1 -> (the trained config, renderer)."""
    cfg = set_frustum_depth(apply_edits(
        nerf_config(root, Path(root) / "out_nerf", epochs=epochs, app=app),
        edits), frustum_depth)
    return nerf_trainer.train(cfg, device=device)


def held_out_psnr(root, trained, app=False, frustum_depth=None,
                  device="cuda", edits=None):
    """Mean PSNR of the held-out (val) views at full size."""
    cfg = serving_config(root, app, frustum_depth, split="val", edits=edits)
    ev = NerfEvaluator(cfg, eval_renderer(cfg, trained, device, stop_layer=-1))
    with torch.no_grad():
        res = ev.eval_data_loader(cache_dir=Path(root) / "val_render")
    return float(np.mean(res["psnr"]))


def cache_stage(root, trained, name="scene_cache", app=False,
                frustum_depth=None, device="cuda", cls=NerfRenderer,
                **serving):
    """Stage 2 -> (scene-point dir, the serving renderer): every frame's
    ds-8 layer-3 points, at the serving mode / threshold in ``serving``."""
    cfg = serving_config(root, app, frustum_depth, **serving)
    renderer = eval_renderer(cfg, trained, device, cls=cls)
    cache = NerfEvaluator(cfg, renderer).cache_scene_pts(
        cache_dir=Path(root) / name)
    return cache, renderer


def train_matchers(root, cache_dir, epochs, device="cuda", backbone=None,
                   full=True, edits=None):
    """Stage 3 -> dict(mini, full: (config, model); warm_start: Mini's
    ``best`` checkpoint and the tensors it grafts into Full)."""
    def cfg(odir, c2f):
        c = apply_edits(matcher_cfg(root, cache_dir, Path(root) / odir,
                                    epochs=epochs, c2f=c2f), edits)
        if backbone:
            c.model.backbone = backbone
        return c

    out = {"mini": train_coarse(cfg("out_match", False), device=device)}
    if not full:
        return out
    best = latest_checkpoint(init_config_odir(out["mini"][0], coarse=True)
                             / "checkpoints", name="best")
    if best is None:
        raise RuntimeError("Mini saved no best checkpoint (no finite "
                           "validation loss)")
    ccfg = cfg("out_match_c2f", True)
    ccfg.model.coarse_ckpt = str(best)
    # What the graft loads, on a throwaway model of the same config.
    probe = build_matcher(ccfg, False, torch.Generator().manual_seed(0))
    out["warm_start"] = {"ckpt": str(best),
                         "tensors": load_pretrained(probe, ccfg.model),
                         "of": len(probe.state_dict())}
    out["full"] = train_c2f(ccfg, device=device)
    return out


def evaluator_of(trained, device):
    """A :class:`NeRFMatchEvaluator` of a trained (config, model)."""
    config, model = trained
    return NeRFMatchEvaluator(config, state_dict=model.state_dict(),
                              device=device)


def localize(evaluator, dataset, renderer, **kw):
    """Every query of ``dataset`` at bs=1 (mutual, PnP at 6 px, the
    colmap-style solver) -> (R_err, t_err, num_matches) arrays."""
    r_errs, t_errs, ns = [], [], []
    with torch.no_grad():
        for i in range(len(dataset)):
            out = evaluator.eval_batch(_collate([dataset[i]]),
                                       renderer=renderer, mutual=True,
                                       rthres=6.0, solver="colmap", **kw)
            r_errs.append(out["R_err"][0])
            t_errs.append(out["t_err"][0])
            ns.append(out["num_matches"][0])
    return np.asarray(r_errs), np.asarray(t_errs), np.asarray(ns)


def recall(r, t):
    return float(np.mean((np.asarray(r) < R_THRES) & (np.asarray(t) < T_THRES)))


def pose_summary(r, t, ns):
    """Medians, match count, recall and the per-query errors of one
    protocol run."""
    return {"r_med": float(np.median(r)), "t_med": float(np.median(t)),
            "matches": int(np.median(ns)), "recall": recall(r, t),
            "R_err": [float(x) for x in r], "t_err": [float(x) for x in t],
            "num_matches": [int(x) for x in ns]}


def inerf_conf():
    return Namespace(num_optim=3, lrate=2e-3, lrdecay=0.6, eval_pose=True,
                     ds=DS, use_match_loss=False)


def run(root, *, enclosed=False, cambridge=False, nerf_epochs=10,
        match_epochs=40, device="cuda", backbone=None, trunk_int8=None,
        frustum_depth=None, nerf_edits=None, matcher_edits=None):
    """The four stages on a fresh scene under ``root`` -> summary dict.
    ``nerf_edits`` / ``matcher_edits``: :func:`apply_edits` entries for the
    NeRF and matcher configs."""
    device = resolve_device(device)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    t_all = time.perf_counter()
    times = {}
    build_scene(root, app_seqs=4 if cambridge else 0, enclosed=enclosed)

    t0 = time.perf_counter()
    _, trained = train_nerf_stage(root, nerf_epochs, cambridge,
                                  frustum_depth, device, nerf_edits)
    times["nerf"] = time.perf_counter() - t0
    summary = {"enclosed": enclosed, "cambridge": cambridge,
               "nerf_epochs": nerf_epochs, "match_epochs": match_epochs,
               "backbone": backbone or "tiny", "trunk_int8": trunk_int8,
               "frustum_depth": frustum_depth or 1}
    if cambridge:
        emb = trained.embedding_a.weight.detach().cpu().numpy()
        summary["appearance_rows"] = int(emb.shape[0])
        summary["appearance_spread"] = float(np.abs(emb - emb.mean(0)).max())
    t0 = time.perf_counter()
    summary["psnr"] = held_out_psnr(root, trained, cambridge, frustum_depth,
                                    device, nerf_edits)
    times["psnr"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cache_dir, renderer = cache_stage(root, trained, app=cambridge,
                                      frustum_depth=frustum_depth,
                                      device=device,
                                      trunk_int8=trunk_int8,
                                      edits=nerf_edits)
    times["cache"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    matchers = train_matchers(root, cache_dir, match_epochs, device, backbone,
                              edits=matcher_edits)
    times["matchers"] = time.perf_counter() - t0
    summary["warm_start"] = matchers["warm_start"]

    t0 = time.perf_counter()
    mini = evaluator_of(matchers["mini"], device)
    full = evaluator_of(matchers["full"], device)
    data = matcher_cfg(root, cache_dir, root / "out_match").data
    ds = NeRFMatchPair(data, split="test")
    protos = [("single", mini, ds, {}), ("c2f-fine", full, ds, {})]
    if cambridge:
        multi = NeRFMatchMultiPair(matcher_cfg(
            root, cache_dir, root / "out_match", multipair=True).data,
            split="test")
        protos.append(("multipair", mini, multi, {}))
    else:
        protos += [("iters2", mini, ds, {"iters": 2}),
                   ("iters2+inerf", mini, ds,
                    {"iters": 2, "inerf_conf": inerf_conf()})]
    summary["protocols"] = {}
    for name, ev, dset, kw in protos:
        summary["protocols"][name] = pose_summary(
            *localize(ev, dset, renderer, **kw))
    times["localize"] = time.perf_counter() - t0
    times["total"] = time.perf_counter() - t_all
    summary["queries"] = len(ds)
    summary["seconds"] = times
    summary["cam_radius"] = CAM_R
    return summary


def build_parser(description=None):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--root", type=Path, required=True,
                   help="a fresh directory for the scene and every output")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", type=Path, default=None,
                   help="also write the summary JSON here")
    return p


def write_summary(summary, out=None):
    text = json.dumps(summary)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(text)
    print(text, flush=True)
    return summary


def main(argv=None):
    p = build_parser(__doc__.splitlines()[0])
    p.add_argument("--enclosed", action="store_true")
    p.add_argument("--cambridge", action="store_true")
    p.add_argument("--nerf_epochs", type=int, default=10)
    p.add_argument("--match_epochs", type=int, default=40)
    args = p.parse_args(argv)
    return write_summary(run(
        args.root, enclosed=args.enclosed, cambridge=args.cambridge,
        nerf_epochs=args.nerf_epochs, match_epochs=args.match_epochs,
        device=args.device), args.out)


if __name__ == "__main__":
    main()
