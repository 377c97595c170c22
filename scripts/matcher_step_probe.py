"""Matcher train steps side by side on one NVIDIA GPU: the c2f step with
and without the FPN backbone (``convformer384_fpn``) and the coarse step
with ``pt_ftype`` ``'nerf'`` and ``'rand'``.

    python3 scripts/matcher_step_probe.py

Builds the kernels, then makes the four steps from the shipped configs
(``configs/nerfmatch/nerfmatch_7scenes_sfm_{c2f,coarse}.yaml``, random
weights from seed 0) on one synthetic batch of the production shapes (2
images of 480x480, 3600 points of 256-d, a GT matrix with 2000 matches),
takes 3 warm-up steps each, then 5 rounds of one step each, the order
reversed every other round, each step timed on the host clock around a
device sync.  Prints each step's times and medians, then one profiled
pass (``torch.profiler``, 2 steps) of the c2f step with and without the
FPN: device ms a step and the 12 kernels with the most device time.
Compare within one run only.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

COARSE_KEYS = ("image", "pt_feat", "pt3d", "im_mask", "pt_mask", "conf_gt")


def synthetic_batch(dev, B=2, N=3600):
    """One batch of the c2f step's inputs at 480x480 (3600 tokens)."""
    g = torch.Generator(dev).manual_seed(0)
    ys, xs = torch.meshgrid(torch.arange(60), torch.arange(60), indexing="ij")
    pt2d = (torch.stack([xs, ys], -1).reshape(-1, 2).float() * 8 + 4).to(dev)
    conf_gt = torch.zeros(B, 3600, N, device=dev)
    idx = torch.randperm(3600, generator=torch.Generator().manual_seed(1))[
        :2000].to(dev)
    conf_gt[:, idx, idx] = 1.0
    return {"image": torch.randn(B, 480, 480, 3, device=dev, generator=g),
            "pt_feat": torch.randn(B, N, 256, device=dev, generator=g),
            "pt3d": torch.randn(B, N, 3, device=dev, generator=g),
            "im_mask": torch.ones(B, 3600, device=dev),
            "pt_mask": torch.ones(B, N, device=dev), "conf_gt": conf_gt,
            "pt2d": pt2d.expand(B, -1, -1).contiguous(),
            "pt2d_proj": pt2d.expand(B, -1, -1)
            + torch.randn(B, N, 2, device=dev, generator=g)}


def make_step(name, coarse, dev, **model):
    """A train step of config ``name`` with ``model`` fields replaced."""
    from nerfmatch_tpu_torch.config import load_yaml_config
    from nerfmatch_tpu_torch.train.matcher_trainer import (
        C2FTrainStep, CoarseTrainStep, build_matcher)
    from nerfmatch_tpu_torch.utils.optim import (init_optimizer,
                                                 trainable_parameters)

    cfg, _ = load_yaml_config(ROOT / "configs/nerfmatch" / name)
    for k, v in model.items():
        setattr(cfg.model, k, v)
    m = build_matcher(cfg, coarse, torch.Generator().manual_seed(0)).to(dev)
    opt = init_optimizer(cfg.optim, trainable_parameters(m), lr=1e-5)
    cls = CoarseTrainStep if coarse else C2FTrainStep
    return cls(m, opt, generator=torch.Generator(dev).manual_seed(0))


def main():
    import chip_smoke as cs

    smi = cs.phase_environment()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    batch = synthetic_batch(dev)
    steps = {
        "c2f": make_step("nerfmatch_7scenes_sfm_c2f.yaml", False, dev),
        "c2f_fpn": make_step("nerfmatch_7scenes_sfm_c2f.yaml", False, dev,
                             backbone="convformer384_fpn"),
        "coarse": make_step("nerfmatch_7scenes_sfm_coarse.yaml", True, dev),
        "coarse_rand": make_step("nerfmatch_7scenes_sfm_coarse.yaml", True,
                                 dev, pt_ftype="rand")}

    def run(name):
        b = batch if name.startswith("c2f") else \
            {k: batch[k] for k in COARSE_KEYS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[name].step(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for n in steps:
        for _ in range(3):
            run(n)
    times = {n: [] for n in steps}
    for r in range(5):
        for n in (list(steps) if r % 2 == 0 else list(steps)[::-1]):
            times[n].append(run(n))
    print("ms a step, 5 in turns:", json.dumps(
        {n: [round(x, 1) for x in v] for n, v in times.items()}))
    print("medians:", json.dumps(
        {n: round(float(np.median(v)), 1) for n, v in times.items()}))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name in ("c2f_fpn", "c2f"):
        with torch.profiler.profile(activities=acts) as prof:
            run(name)
            run(name)
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
        dev_ms = sum(e.self_device_time_total for e in ka) / 1e3 / 2
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:12]
        print(f"{name}: device {dev_ms:.1f} ms a step; top kernels (ms a "
              "step): " + json.dumps({e.key[:90]: round(
                  e.self_device_time_total / 2e3, 2) for e in top}))
    print(smi)


if __name__ == "__main__":
    main()
