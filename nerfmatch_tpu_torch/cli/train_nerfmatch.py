"""Matcher training CLI, coarse ("Mini") and coarse-to-fine ("Full")
(counterpart of ``nerfmatch_tpu/cli/train_nerfmatch.py``): a YAML config,
the same flags, and ``--update_conf`` to write the architecture / optim /
data flags into it.

    python -m nerfmatch_tpu_torch.cli.train_nerfmatch \\
        --config configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml --stage c2f
"""

from __future__ import annotations

import argparse

import torch

from ..config import load_yaml_config, merge_configs
from ..train.matcher_trainer import train_c2f, train_coarse


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--stage", type=str, default="c2f", choices=["coarse", "c2f"])
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu.")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd.set_detect_anomaly: raise at the "
                        "op producing a NaN (debug only, slow).")
    p.add_argument("--update_conf", action="store_true")
    # Arch flags
    p.add_argument("--backbone", type=str, default="convformer384")
    p.add_argument("--pt_dim", type=int, default=256)
    p.add_argument("--pt_sa", type=int, default=3)
    p.add_argument("--im_sa", type=int, default=3)
    p.add_argument("--pt_sa_type", type=str, default="full")
    p.add_argument("--coarse_layers", type=int, default=1)
    p.add_argument("--cformer_type", type=str, default="crs")
    p.add_argument("--cfeat_dim", type=int, default=256)
    p.add_argument("--pt_pe", action="store_true")
    p.add_argument("--im_pe", action="store_true")
    p.add_argument("--pt_ftype", type=str, default="nerf")
    p.add_argument("--pt_pe_type", type=str, default="fourier")
    p.add_argument("--temp_type", type=str, default="mul")
    p.add_argument("--fsa_type", type=str, default="full")
    p.add_argument("--fine_sa", type=int, default=1)
    p.add_argument("--coarse_ckpt", type=str, default=None)
    p.add_argument("--c2f_ckpt", type=str, default=None)
    # Optim / data flags
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--coarse_only_epochs", type=int, default=0)
    p.add_argument("--clr", type=float, default=4e-4)
    p.add_argument("--cbs", type=int, default=16)
    p.add_argument("--epoch_sample_num", type=int, default=10000)
    p.add_argument("--pair_topk", type=int, default=30)
    p.add_argument("--aug_self_pairs", type=int, default=10)
    p.add_argument("--train_pair_txt", type=str, default=None)
    p.add_argument("--prefix", type=str, default=None)
    p.add_argument("--gpus", type=int, default=None,
                   help="Devices; more than 1 is not ported and raises "
                        "(ROADMAP Queue 1 item 10).")
    p.add_argument("--scene_dir", type=str, default=None)
    p.add_argument("--scenes", type=str, nargs="*", default=None)
    p.add_argument("--resume_version", type=str, default=None)
    return p


def apply_update_conf(config, args):
    config.model.coarse_ckpt = args.coarse_ckpt
    config.model.c2f_ckpt = args.c2f_ckpt
    config.model.backbone = args.backbone
    config.model.pt_dim = args.pt_dim
    config.model.pt_sa = args.pt_sa
    config.model.im_sa = args.im_sa
    config.model.pt_sa_type = args.pt_sa_type
    config.model.coarse_layers = args.coarse_layers
    config.model.cformer_type = args.cformer_type
    config.model.cfeat_dim = args.cfeat_dim
    config.model.pt_pe = args.pt_pe
    config.model.im_pe = args.im_pe
    config.model.pt_ftype = args.pt_ftype
    config.model.pt_pe_type = args.pt_pe_type
    config.model.temp_type = args.temp_type
    config.model.fsa_type = args.fsa_type
    config.model.fine_sa = args.fine_sa
    config.exp.batch_size = args.batch_size
    config.exp.max_epochs = args.max_epochs
    config.optim.coarse_only_epochs = args.coarse_only_epochs
    config.optim.clr = args.clr
    config.optim.cbs = args.cbs
    config.data.epoch_sample_num = args.epoch_sample_num
    config.data.pair_topk = args.pair_topk
    config.data.aug_self_pairs = args.aug_self_pairs
    if args.train_pair_txt:
        config.data.train_pair_txt = args.train_pair_txt
    if args.prefix:
        config.exp.prefix = args.prefix
    if args.gpus is not None:
        config.exp.gpus = args.gpus
    if args.scene_dir:
        config.data.scene_dir = args.scene_dir
    if args.scenes:
        config.data.scenes = args.scenes
    if args.resume_version:
        config.exp.resume_version = args.resume_version


def main(argv=None, stage=None):
    args = build_parser().parse_args(argv)
    if stage is not None:
        args.stage = stage
    config, _ = load_yaml_config(args.config)
    config = merge_configs(config, args)
    if args.update_conf:
        apply_update_conf(config, args)
    if args.debug:
        config.exp.debug = True
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    if args.stage == "coarse":
        return train_coarse(config, device=args.device)
    return train_c2f(config, device=args.device)


if __name__ == "__main__":
    main()
