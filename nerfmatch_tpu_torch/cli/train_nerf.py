"""NeRF training CLI (counterpart of ``nerfmatch_tpu/cli/train_nerf.py``).

    python -m nerfmatch_tpu_torch.cli.train_nerf --config configs/nerf/nerf_7scenes_mip_sfm.yaml

Same flags as the JAX CLI, without its compile cache; ``--detect_anomaly``
turns on ``torch.autograd.set_detect_anomaly``, ``--device cpu`` trains on
the CPU (the default is the GPU).  Several GPUs train one process each
(``exp.batch_size`` stays the global batch):

    torchrun --nproc_per_node=N -m nerfmatch_tpu_torch.cli.train_nerf --config ...

or the JAX package's contract (``NERFMATCH_COORDINATOR=host:port``,
``NERFMATCH_NUM_PROCESSES``, ``NERFMATCH_PROCESS_ID`` in each process's
environment; ``parallel.distributed.maybe_initialize_distributed``).
"""

from __future__ import annotations

import argparse

from ..config import load_yaml_config, merge_configs
from ..parallel.distributed import maybe_initialize_distributed
from ..train.nerf_trainer import train


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="Path to (.yml) config file.")
    parser.add_argument("--scene", type=str, default=None)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--prefix", type=str, default=None)
    parser.add_argument("--gpus", type=int, default=None,
                        help="Cap on the GPUs to train on (default: every "
                             "launched process, one a GPU); a cap below the "
                             "launched processes raises.")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="Raise at the op producing a NaN in the "
                             "backward (debug only, slow).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    maybe_initialize_distributed(device=args.device)
    config, _ = load_yaml_config(args.config)
    config = merge_configs(config, args)
    if args.scene is not None:
        config.data.scene = args.scene
    if args.max_epochs is not None:
        config.exp.max_epochs = args.max_epochs
    if args.batch_size is not None:
        config.exp.batch_size = args.batch_size
    if args.prefix is not None:
        config.exp.prefix = args.prefix
    if args.gpus is not None:
        config.exp.gpus = args.gpus
    if args.debug:
        config.exp.debug = True
        config.exp.prefix = "debug"
    if args.detect_anomaly:
        import torch

        torch.autograd.set_detect_anomaly(True)
    return train(config, device=args.device)


if __name__ == "__main__":
    main()
