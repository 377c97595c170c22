"""Data-parallel training over NCCL and sharded evaluation over the GPUs of
one host.

* The steps of ``chip_smoke.py`` phase 9b (3 full-width NeRF steps of 9216
  room rays, production c2f steps of one pair a rank; SGD), each rank in
  its own process on its own GPU, held to one process's steps over the same
  global batches, with each rank's ms a step and peak memory, and the
  per-rank-normalized control.
* Phase 9c on a mesh of every GPU (``cuda:0``, ``cuda:1``, ...): point- and
  pair-sharded matching at 3600 x 14,400 held to the dense path on
  ``cuda:0``, and the sharded render of 9216 rays to ``fused_predict``.

    python3 scripts/dp_nccl_probe.py [--only train|eval]

Needs two GPUs or more; builds the kernels first.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=("train", "eval"), default=None)
    args = p.parse_args()
    smi = cs.phase_environment()
    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit(f"dp_nccl_probe: {world} GPU; needs two or more")
    cs.phase_build()
    dev = torch.device("cuda", 0)
    if args.only != "eval":
        with tempfile.TemporaryDirectory() as tmp:
            cs.phase9_ranks(dev, 0, Path(tmp), world=world, backend="nccl")
        torch.cuda.empty_cache()
    if args.only != "train":
        from nerfmatch_tpu_torch.config import load_yaml_config

        nerf_cfg, _ = load_yaml_config(
            ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
        cs.phase9_sharded_eval(
            cs.load_room_renderer(dev), nerf_cfg, dev, 0,
            devices=[torch.device("cuda", i) for i in range(world)])
    cs.log(f"{world} x {smi}")


if __name__ == "__main__":
    main()
