"""Train the JAX package's Mini and Full matchers (the e2e pipeline's stage
3: ``train_coarse``, then ``train_c2f`` warm-started from Mini's ``best``
through ``model.coarse_ckpt``) on a scene-point cache rendered elsewhere,
on the CPU (the trainers log each epoch's mean training loss), then
localize the query pairs single-shot with each (``localize``).

The scene is ``scripts/e2e_full_pipeline_tpu.py``'s enclosed one (which
``nerfmatch_tpu_torch.e2e.scene`` writes byte for byte); CACHE is a
``ds8lin`` directory of its 30 frames, e.g. the ``cache_none`` arm of
``python -m nerfmatch_tpu_torch.e2e.gates``, so the two packages' matcher
training can be compared on the same inputs.

Run: python scripts/jax_matchers_on_cache.py ROOT CACHE [EPOCHS]
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from pathlib import Path

os.environ.setdefault("NERFMATCH_COMPILE_CACHE", "0")
os.environ["E2E_ENCLOSED"] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(root, cache, epochs=40):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nerfmatch_tpu.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu.train.matcher_trainer import (init_config_odir,
                                                     train_c2f, train_coarse)
    from scripts.e2e_full_pipeline_tpu import build_scene, matcher_cfg

    root = Path(root)
    build_scene(root)
    scene_dir = root / "scene_cache" / "ds8lin"
    if not scene_dir.exists():
        shutil.copytree(cache, scene_dir)
    t0 = time.time()
    mcfg = matcher_cfg(root, scene_dir, root / "out_match", epochs=epochs)
    mcfg.exp.num_workers = 0
    out_mcfg, mparams = train_coarse(mcfg)
    best = latest_checkpoint(init_config_odir(out_mcfg, coarse=True)
                             / "checkpoints", name="best")
    ccfg = matcher_cfg(root, scene_dir, root / "out_match_c2f",
                       epochs=epochs, c2f=True)
    ccfg.exp.num_workers = 0
    ccfg.model.coarse_ckpt = str(best)
    _, cparams = train_c2f(ccfg)
    print(f"Mini and Full trained in {time.time() - t0:.0f} s; Full "
          f"warm-started from {best}", flush=True)
    localize(root, scene_dir, mparams, cparams)


def localize(root, scene_dir, mparams, cparams):
    """The e2e pipeline's cached-point protocols with the JAX evaluator:
    every query pair single-shot with Mini and with Full (mutual, PnP at
    6 px, the colmap-style solver) -> prints the medians and recall."""
    import numpy as np

    from nerfmatch_tpu.data import NeRFMatchPair
    from nerfmatch_tpu.data.loaders import _collate
    from nerfmatch_tpu.eval.match_evaluator import NeRFMatchEvaluator
    from scripts.e2e_full_pipeline_tpu import matcher_cfg

    ds = NeRFMatchPair(matcher_cfg(root, scene_dir, root / "out_match").data,
                       split="test")
    for name, params, c2f in (("single", mparams, False),
                              ("c2f-fine", cparams, True)):
        ev = NeRFMatchEvaluator(matcher_cfg(root, scene_dir, root / "eval",
                                            c2f=c2f), params=params)
        r, t = [], []
        for i in range(len(ds)):
            out = ev.eval_batch(_collate([ds[i]]), mutual=True, rthres=6.0,
                                solver="colmap")
            r.append(out["R_err"][0])
            t.append(out["t_err"][0])
        r, t = np.asarray(r), np.asarray(t)
        print(f"[{name}] median R={np.median(r):.3f} deg t={np.median(t):.4f} "
              f"recall@(5deg,0.05)={np.mean((r < 5) & (t < 0.05)):.3f} over "
              f"{len(r)} queries", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3
         else 40)
