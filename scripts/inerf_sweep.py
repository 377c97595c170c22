"""iNeRF convergence on the room fixture at full width, on one GPU.

    python3 scripts/inerf_sweep.py [--steps 30] [--angles 0.3 2.4]

For each query pose on the room's camera circle (``chip_smoke.room_c2w``)
the query is the iNeRF render of that pose on the ds-8 grid of a 480x480
camera (3600 rays, 128 + 128 samples, the 8x256 MLP; white background, as
iNeRF composites).  From the pose turned by ``deg`` degrees and moved by
``dist`` world units (``chip_smoke.perturbed_pose``) it runs ``--steps``
Adam steps scored on the pose, with the cosine decay, for each learning
rate, on the serving renderer (int8 coarse stage + resample kernel); one
cell also with the JAX package's plain half (``plain=True``).  Prints one
JSON line a run: the loss at the first and the last step, and (loss,
R_err deg, t_err) after steps 5, 10, 20 and the last.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402

STARTS = ((2, 0.05), (2, 0.02), (1, 0.02), (1, 0.05), (0.5, 0.01), (0, 0.05),
          (2, 0.0))
LRATES = (0.001, 0.002, 0.005, 0.01)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--angles", type=float, nargs="*", default=[0.3, 2.4])
    args = p.parse_args()
    print(S.phase_environment(), flush=True)
    S.phase_build()
    from nerfmatch_tpu_torch.config import load_yaml_config
    from nerfmatch_tpu_torch.eval.inerf import InerfQuery
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.utils.geometry import pose_err

    dev = torch.device("cuda", 0)
    renderer = copy.deepcopy(S.load_room_renderer(dev))
    renderer.cfg = dataclasses.replace(renderer.cfg, trunk_int8="coarse")
    match_cfg, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    ev = NeRFMatchEvaluator(match_cfg, device=dev,
                            generator=torch.Generator().manual_seed(0))
    size, ds, g, un = 480, 8, 60, np.eye(4)
    K = S.camera_K(size)
    with torch.no_grad():
        renderer.calibrate_int8(
            S.camera_rays(S.room_c2w(args.angles[0]), size, dev)[:1024])
        for ang in args.angles:
            c2w = S.room_c2w(ang)
            img = np.zeros((size, size, 3), np.float32)
            batch = dict(image=img[None], K=K[None],
                         c2w=c2w[None].astype(np.float32))
            base = Namespace(lrate=0.0, num_optim=args.steps, lrdecay=True,
                             eval_pose=True, ds=ds, use_match_loss=False)
            gt = InerfQuery(ev, batch, renderer, un, c2w, base)
            img[ds // 2::ds, ds // 2::ds] = gt.render(gt.delta)[0].reshape(
                g, g, 3).cpu().numpy()
            for deg, dist in STARTS:
                start = S.perturbed_pose(c2w, deg, dist)
                for lr in LRATES:
                    both = (deg, dist, lr) == (2, 0.05, 0.005)
                    for plain in ((False, True) if both else (False,)):
                        q = InerfQuery(ev, batch, renderer, un, start,
                                       Namespace(**{**vars(base), "lrate": lr}),
                                       plain=plain)
                        rows = []
                        for j in range(args.steps):
                            loss = q.step(j)[0]
                            rows.append((loss, *map(float, pose_err(c2w,
                                                                    q.c2w()))))
                        at = [k for k in (4, 9, 19) if k < args.steps - 1]
                        print(json.dumps(dict(
                            ang=ang, deg=deg, dist=dist, lr=lr, plain=plain,
                            loss0=rows[0][0], loss_end=rows[-1][0],
                            at=[[round(v, 4) for v in rows[k]]
                                for k in (*at, args.steps - 1)])), flush=True)


if __name__ == "__main__":
    main()
