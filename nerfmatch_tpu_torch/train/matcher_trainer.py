"""Matcher training, coarse ("Mini") and coarse-to-fine ("Full")
(counterpart of ``nerfmatch_tpu/train/matcher_trainer.py``).

* the focal matching loss on the dual-softmax conf matrix, the feature-l2
  metric;
* c2f adds the fine loss (``'match'``: global-pixel l2/std, ``'exp'``: the
  LoFTR local expectation) over a fixed-budget match list padded with GT
  (``pad_matches_with_gt``), with the ``coarse_only_epochs`` curriculum;
* the batch-size-adaptive LR ``clr * batch / cbs``, the per-epoch schedule;
* per-epoch validation: the losses over predicted matches and host PnP pose
  metrics; checkpoints on the best val loss, the best median translation,
  and the last epoch (with resume).

One process a device: under a process group (``parallel.distributed``)
each rank loads its block of every global batch of ``exp.batch_size``
pairs; the loss normalizers (positive and negative counts, valid fine rows,
the batch mean) are the global batch's, the GT-padded match list is drawn
over the global batch from the generator every rank holds alike (each rank
runs the fine stage on the list's rows of its pairs), and one all-reduce
sums the gradients, so W ranks take one process's step.  Rank 0 alone
writes checkpoints and logs; validation is split over the ranks and its
errors and losses gathered.  On CUDA the coarse attention layers run the
attention kernels (forward and backward) and the ConvFormer token mixers
the fused StarReLU + depthwise-conv kernels; on the CPU both take their
plain versions.  GT-padding draws and the ``pt_ftype='rand'`` descriptors
(one draw a step) come from a ``torch.Generator`` seeded with ``exp.seed``
(or an injected match list and ``rand_feat``, for tests).  Multi-pair data
(``NeRFMatchMultiPair``) trains in the merged layout (``sample_mode: rand``,
points (B, N, .)); the stacked layout raises ``ValueError``, as the JAX
trainer fails on it.  An ``*_fpn`` backbone trains with its BatchNorm on
the running statistics, which train as parameters (the JAX package's
leaves).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..config import namespace2dict
from ..data.loaders import init_data_loader
from ..models.layers import init_params_
from ..models.matcher_c2f import C2FMatcherConfig, NeRFMatcherMS
from ..models.matcher_coarse import (CoarseMatcherConfig, NeRFMatcherCoarse,
                                     rand_point_features)
from ..ops.matching import (dense_to_match_lists, dual_softmax,
                            extract_mutual_matches, pad_matches_with_gt)
from ..parallel.distributed import DataGroup, check_world, rank_seed
from ..parallel.mesh import all_gather_host, replicate_params
from ..utils import get_logger, resolve_device
from ..utils.metrics import (compute_feat_l2, compute_fine_loss_l2_std,
                             compute_fine_match_loss_l2_std,
                             compute_matching_loss, compute_pose_metrics_host)
from ..utils.optim import (config_adaptive_lr, get_lr, init_optimizer,
                           make_lr_schedule, set_lr, trainable_parameters)
from .checkpoint import (convert_timm_backbone, graft_state,
                         latest_checkpoint, load_checkpoint,
                         load_reference_checkpoint, load_timm_state,
                         nest_backbone, save_checkpoint)
from .logging import MetricsLogger, NullLogger

logger = get_logger(level="INFO", name="matcher_trainer")

BATCH_KEYS = ("image", "pt_feat", "pt3d", "im_mask", "pt_mask", "conf_gt")
C2F_KEYS = BATCH_KEYS + ("pt2d", "pt2d_proj")


def coarse_losses(conf, conf_gt, im_n, pt_n, clamp: bool, group=None):
    return (compute_matching_loss(conf, conf_gt, clamp=clamp, group=group),
            compute_feat_l2(im_n, pt_n, conf_gt, group=group))


STACKED_MULTIPAIR = (
    "multi-pair training takes the merged layout, points (B, N, .): the "
    "stacked layout's (B, K, N, .) points do not reach the dual softmax (the "
    "JAX trainer fails there too); set data.sample_mode: rand and "
    "data.sample_pts")


def coarse_features(model, image, pt_feat, pt3d, im_mask, pt_mask,
                    generator=None, rand_feat=None, group=None):
    """Shared head of both loss bodies -> (conf, im_n, pt_n, im_cfeat,
    pt_cfeat, fine map or None).  ``generator`` / ``rand_feat``: the
    ``pt_ftype='rand'`` descriptors' draw (``extract_pt_feat``; with a
    data-parallel ``group``, the global batch's draw cut to this rank's
    rows)."""
    if pt3d.dim() != 3:
        raise ValueError(STACKED_MULTIPAIR)
    if group is not None and rand_feat is None \
            and model.cfg.pt_ftype == "rand":
        B, N = pt3d.shape[:2]
        rand_feat = rand_point_features(
            (B * group.world, N), model.cfg.effective_pt_dim, pt3d.device,
            generator)[group.rows(B)]
    if isinstance(model, NeRFMatcherMS):
        im_cfeat, fmap_f = model.extract_im_feat_ms(image)
    else:
        im_cfeat, fmap_f = model.extract_im_feat(image), None
    pt_cfeat = model.extract_pt_feat(pt_feat, pt3d, generator=generator,
                                     rand_feat=rand_feat)
    im_cfeat, pt_cfeat = model.apply_coarse_former(im_cfeat, pt_cfeat)
    conf, im_n, pt_n = dual_softmax(im_cfeat, pt_cfeat, model.temperature,
                                    im_mask, pt_mask,
                                    temp_type=model.cfg.temp_type)
    return conf, im_n, pt_n, im_cfeat, pt_cfeat, fmap_f


class _TrainStep:
    """``group``: the data-parallel group (``parallel.distributed
    .DataGroup``), None in one process."""

    def __init__(self, model, opt, generator: torch.Generator | None = None,
                 group: DataGroup | None = None):
        self.model = model
        self.opt = opt
        self.generator = generator
        self.group = group

    def step(self, batch, **kw):
        """One optimizer step on a batch dict of device tensors (this
        rank's block of the global batch) -> detached metrics of the
        global batch."""
        loss, metrics = self.losses(batch, **kw)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.group is not None:
            self.group.reduce_grads(p for g in self.opt.param_groups
                                    for p in g["params"])
            metrics = self.group.sum_metrics(metrics)
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}


class CoarseTrainStep(_TrainStep):
    """Coarse matcher step: focal loss (no clamp) on the conf matrix."""

    def losses(self, batch, rand_feat=None):
        """-> (loss, metrics).  ``rand_feat``: injected ``pt_ftype='rand'``
        descriptors (else drawn from the step's generator)."""
        conf, im_n, pt_n, *_ = coarse_features(
            self.model, *(batch[k] for k in BATCH_KEYS[:5]),
            generator=self.generator, rand_feat=rand_feat, group=self.group)
        coarse_loss, feat_l2 = coarse_losses(conf, batch["conf_gt"], im_n,
                                             pt_n, clamp=False,
                                             group=self.group)
        return coarse_loss, {"coarse_loss": coarse_loss, "feat_l2": feat_l2,
                             "loss": coarse_loss}

    @torch.no_grad()
    def val_forward(self, batch):
        out = self.model.forward_match(*(batch[k] for k in BATCH_KEYS[:5]),
                                       ret_feats=True)
        coarse_loss, feat_l2 = coarse_losses(
            out["conf_matrix"], batch["conf_gt"], out["im_cfeat"],
            out["pt_cfeat"], clamp=False)
        metrics = {"coarse_loss": coarse_loss, "feat_l2": feat_l2,
                   "loss": coarse_loss}
        return metrics, {k: out[k] for k in ("j_ids", "mconf", "valid")}


def _fine_loss(model, expec_f, mpt2d_c, mpt2d_f_gt, coarse_pos, valid,
               training: bool, group=None):
    cfg = model.cfg
    if cfg.fine_loss == "match":
        return compute_fine_match_loss_l2_std(
            model.fine_coords(expec_f, mpt2d_c), mpt2d_f_gt, expec_f[:, 2],
            mask=coarse_pos, valid=valid, group=group)
    # The reference's floor division (kept): it agrees with fine_coords'
    # win_sz / 2 * fine_ds at the production win_sz=5, fine_ds=2 only.
    radius = cfg.fine_ds * cfg.win_sz // 2
    return compute_fine_loss_l2_std(expec_f, (mpt2d_f_gt - mpt2d_c) / radius,
                                    training=training, valid=valid,
                                    group=group)


class C2FTrainStep(_TrainStep):
    """Coarse-to-fine step: clamped focal loss plus the fine loss over the
    GT-padded match list."""

    def losses(self, batch, coarse_only: bool = False, mlist=None,
               draws=None, rand_feat=None):
        """-> (loss, metrics).  ``mlist``: an injected match list (dict of
        b_ids, i_ids, j_ids, valid; with a group, the global batch's);
        ``draws``: injected GT-padding draws; ``rand_feat``: injected
        ``pt_ftype='rand'`` descriptors.  The generator draws the
        descriptors before the padding."""
        model, cfg, group = self.model, self.model.cfg, self.group
        conf, im_n, pt_n, im_cfeat, pt_cfeat, fmap_f = coarse_features(
            model, *(batch[k] for k in BATCH_KEYS[:5]),
            generator=self.generator, rand_feat=rand_feat, group=group)
        conf_gt = batch["conf_gt"]
        coarse_loss, feat_l2 = coarse_losses(conf, conf_gt, im_n, pt_n,
                                             clamp=True, group=group)
        if mlist is None:
            matches = extract_mutual_matches(conf.detach(), mutual=False,
                                             threshold=0.0)
            if group is not None:
                matches = {k: group.gather(v) for k, v in matches.items()}
            mlist = pad_matches_with_gt(
                matches, conf_gt, coarse_percent=cfg.coarse_percent,
                train_percent=0.3, generator=self.generator, draws=draws,
                group=group)
        b_ids, i_ids, j_ids, valid = (mlist[k] for k in
                                      ("b_ids", "i_ids", "j_ids", "valid"))
        n_slots = b_ids.shape[0]
        if group is not None:
            # This rank's pairs' rows of the global list, in list order.
            B = conf.shape[0]
            own = torch.nonzero(b_ids.long() // B == group.rank)[:, 0]
            b_ids, i_ids, j_ids, valid = (x[own] for x in
                                          (b_ids, i_ids, j_ids, valid))
            b_ids = b_ids - group.rank * B
        b_ids, i_ids, j_ids = (x.long() for x in (b_ids, i_ids, j_ids))
        expec_f = model.forward_fine(fmap_f, im_cfeat, pt_cfeat, b_ids, i_ids,
                                     j_ids)
        mpt2d_c = batch["pt2d"][b_ids, i_ids]
        mpt2d_f_gt = batch["pt2d_proj"][b_ids, j_ids]
        coarse_dist = torch.linalg.norm(mpt2d_f_gt - mpt2d_c, dim=-1)
        coarse_pos = coarse_dist < cfg.coarse_dthres
        fine_loss = _fine_loss(model, expec_f, mpt2d_c, mpt2d_f_gt,
                               coarse_pos, valid, training=True, group=group)
        # torch.where, as the JAX step: the fine leaves get zero (not no)
        # gradients in the coarse-only epochs.
        loss = torch.where(torch.as_tensor(coarse_only, device=conf.device),
                           coarse_loss, coarse_loss + fine_loss)
        if group is None:
            dist_mean = coarse_dist.mean()
            pos_ratio = coarse_pos.float().mean() * 100
        else:                   # this rank's share of the list's means
            dist_mean = coarse_dist.sum() / n_slots
            pos_ratio = coarse_pos.float().sum() / n_slots * 100
        return loss, {"coarse_loss": coarse_loss, "fine_loss": fine_loss,
                      "feat_l2": feat_l2, "coarse_dist": dist_mean,
                      "coarse_pos_ratio": pos_ratio, "loss": loss}

    @torch.no_grad()
    def val_forward(self, batch, coarse_only: bool = False):
        """Val losses over the *predicted* dense match list, masked by the
        match validity; zero-match batches fall back to the coarse loss."""
        model, cfg = self.model, self.model.cfg
        out = model.forward_match(*(batch[k] for k in BATCH_KEYS[:5]),
                                  ret_feats=True)
        coarse_loss, feat_l2 = coarse_losses(
            out["conf_matrix"], batch["conf_gt"], out["im_cfeat"],
            out["pt_cfeat"], clamp=True)
        b_ids, i_ids, j_ids = (out[f"fine_{k}_ids"].long() for k in "bij")
        valid = out["valid"].reshape(-1)
        expec_f = out["expec_f"]
        mpt2d_c = batch["pt2d"][b_ids, i_ids]
        mpt2d_f_gt = batch["pt2d_proj"][b_ids, j_ids]
        coarse_dist = torch.linalg.norm(mpt2d_f_gt - mpt2d_c, dim=-1)
        coarse_pos = (coarse_dist < cfg.coarse_dthres) & valid
        fine_loss = _fine_loss(model, expec_f, mpt2d_c, mpt2d_f_gt,
                               coarse_pos, valid, training=False)
        n_valid = valid.sum()
        loss = torch.where(torch.as_tensor(coarse_only, device=valid.device)
                           | (n_valid == 0),
                           coarse_loss, coarse_loss + fine_loss)
        denom = n_valid.clamp(min=1)
        metrics = {"coarse_loss": coarse_loss, "fine_loss": fine_loss,
                   "feat_l2": feat_l2,
                   "coarse_dist": torch.where(valid, coarse_dist, 0.0).sum()
                   / denom,
                   "coarse_pos_ratio": coarse_pos.float().sum() / denom * 100,
                   "loss": loss}
        return metrics, {k: out[k] for k in ("j_ids", "mconf", "valid",
                                             "expec_f")}


def eval_batch_pose(model, batch, out, rthres: float = 1.0,
                    max_matches: int = 1024, solver: str = "native"):
    """Host PnP over the top ``max_matches`` predicted matches of each item
    of a val batch (``out`` from ``val_forward``; ``batch`` numpy) -> per
    sample pose metrics."""
    lists = {k: v.cpu().numpy() for k, v in dense_to_match_lists(
        {k: out[k] for k in ("j_ids", "mconf", "valid")}, max_matches).items()}
    use_fine = "expec_f" in out
    B, M = out["j_ids"].shape
    expec_f = out["expec_f"].reshape(B, M, 3).cpu() if use_fine else None
    items = []
    for b in range(B):
        valid = lists["valid"][b]
        i_ids, j_ids = lists["i_ids"][b][valid], lists["j_ids"][b][valid]
        pt2d = np.asarray(batch["pt2d"][b])[i_ids]
        if use_fine:
            pt2d = model.fine_coords(expec_f[b][torch.from_numpy(i_ids).long()],
                                     torch.from_numpy(pt2d).float()).numpy()
        items.append({"pt2d": pt2d, "pt3d": np.asarray(batch["pt3d"][b])[j_ids],
                      "K": np.asarray(batch["K"][b]),
                      "c2w_gt": np.asarray(batch["c2w"][b])})
    return compute_pose_metrics_host(items, rthres=rthres, solver=solver)


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

def init_config_odir(config, coarse: bool):
    data = config.data
    scene = data.scenes[0] if hasattr(data, "scenes") and len(data.scenes) == 1 \
        else getattr(data, "scene", "all")
    data_tag = f"{data.dataset}_{scene}_wh{data.img_wh[0]}-{data.img_wh[1]}"
    mconf = config.model
    model_tag = f"{mconf.backbone}" + ("_pre" if mconf.pretrained else "")
    model_tag += f"_cf{getattr(mconf, 'coarse_layers', 0)}d{mconf.cfeat_dim}"
    if not coarse:
        model_tag += (f"_f{getattr(mconf, 'ffeat_dim', 128)}"
                      f"w{getattr(mconf, 'win_sz', 5)}")
    exp = config.exp
    config.optim.max_epochs = exp.max_epochs
    prefix = "debug" if getattr(exp, "debug", False) else getattr(exp, "prefix", "")
    batch_tag = (f"g{config.gpu_num}clr{config.optim.clr}cbs{config.optim.cbs}"
                 if getattr(config.optim, "adapt_lr", True)
                 else f"lr{config.optim.lr}b{exp.batch_size}")
    exp.name = "/".join(x for x in [prefix, data_tag, model_tag,
                                    f"{batch_tag}_ep{exp.max_epochs}"] if x)
    exp.resume_version = getattr(exp, "resume_version", "version_0")
    return Path(str(exp.odir)) / exp.name / exp.resume_version


def check_matcher_config(config, world: int):
    """``exp.gpus`` caps the devices (``nerf_trainer.check_world``), and
    the global batch must divide over the launched processes: the JAX
    trainer shrinks its mesh to the gcd of the two, a launched world
    cannot shrink."""
    check_world(config, world)
    if int(config.exp.batch_size) % world:
        raise ValueError(f"exp.batch_size={config.exp.batch_size} (the "
                         f"global batch) does not divide over {world} "
                         "processes: launch a world that divides it")


def build_matcher(config, coarse: bool, generator: torch.Generator):
    if coarse:
        model = NeRFMatcherCoarse(CoarseMatcherConfig.from_namespace(config.model))
    else:
        model = NeRFMatcherMS(C2FMatcherConfig.from_namespace(config.model))
    return init_params_(model, generator)


# Local file names of the ImageNet ConvFormer weights (timm names).
TIMM_CKPT_NAMES = {
    "convformer": "convformer_b36.sail_in1k.pth",
    "convformer384": "convformer_b36.sail_in1k_384.pth",
}
_REPO_ROOT = Path(__file__).resolve().parents[2]
_WARM_KEYS = ("coarse_ckpt", "c2f_ckpt", "finetune")


def init_imagenet_backbone(model, model_conf):
    """ImageNet-pretrained ConvFormer trunk from a local raw-timm file
    (``model.timm_ckpt``, or ``pretrained/<timm name>.pth``).  A configured
    file that is missing raises; an absent default warns and the trunk
    trains from scratch.  Skipped when a full-model warm start is set.
    -> number of trunk tensors loaded."""
    if not getattr(model_conf, "pretrained", False):
        logger.info("model.pretrained=false: backbone trains from scratch")
        return 0
    if any(getattr(model_conf, k, None) for k in _WARM_KEYS):
        return 0
    ckpt = getattr(model_conf, "timm_ckpt", None)
    if ckpt is None:
        name = TIMM_CKPT_NAMES.get(getattr(model_conf, "backbone", ""))
        default = (_REPO_ROOT / "pretrained" / name) if name else None
        if default is None or not default.exists():
            logger.warning(
                "model.pretrained=true but no ImageNet weights available "
                f"(set model.timm_ckpt, or place {default or 'a timm ckpt'})"
                " — the ConvFormer backbone trains FROM SCRATCH; expect "
                "lower matcher quality than the reference, which always "
                "starts from ImageNet.")
            return 0
        ckpt = default
    elif not Path(ckpt).exists():
        raise FileNotFoundError(
            f"configured model.timm_ckpt does not exist: {ckpt}")
    trunk = model.backbone.model if isinstance(model, NeRFMatcherMS) \
        else model.backbone
    loaded, missing = convert_timm_backbone(trunk, load_timm_state(ckpt))
    if not loaded:
        raise ValueError(f"timm checkpoint {ckpt} matched no backbone tensor "
                         f"of model.backbone={model_conf.backbone}")
    logger.info(f"ImageNet init: {len(loaded)}/{len(loaded) + len(missing)} "
                f"backbone tensors from {ckpt}")
    return len(loaded)


def load_pretrained(model, model_conf):
    """Warm start from ``c2f_ckpt`` / ``finetune`` / ``coarse_ckpt``: a port
    checkpoint directory or a reference Lightning ``.ckpt``; every
    same-name same-shape tensor is copied, after the backbone remap when a
    coarse checkpoint goes into the two-scale model -> tensors loaded."""
    c2f_ckpt = getattr(model_conf, "c2f_ckpt", None)
    finetune = getattr(model_conf, "finetune", None)
    ckpt = c2f_ckpt or finetune or getattr(model_conf, "coarse_ckpt", None)
    if not ckpt:
        return 0
    if not Path(ckpt).exists():
        raise FileNotFoundError(
            f"configured pretrained checkpoint does not exist: {ckpt}")
    ms_model = isinstance(model, NeRFMatcherMS)
    if Path(ckpt).is_dir():
        state = torch.load(Path(ckpt) / "model.pt", map_location="cpu",
                           weights_only=True)
        ms_ckpt = any(k.startswith("backbone.model.") for k in state)
    else:
        state = load_reference_checkpoint(ckpt)[0]
        ms_ckpt = ckpt == c2f_ckpt or (ckpt == finetune and ms_model)
    if ms_model and not ms_ckpt:
        state = nest_backbone(state)
    loaded, missing = graft_state(model, state)
    logger.info(f"Loaded pretrained {ckpt}: {len(loaded)} tensors, "
                f"{len(missing)} stay at init")
    return len(loaded)


def _finite_mean(values):
    """Mean ignoring inf / nan entries; inf when nothing is finite."""
    arr = np.asarray(values, np.float64)
    ok = np.isfinite(arr)
    return float(arr[ok].mean()) if ok.any() else float("inf")


def to_device(batch, keys, device):
    """Model inputs of a collated numpy batch as f32 device tensors."""
    return {k: torch.as_tensor(np.asarray(batch[k], np.float32), device=device)
            for k in keys if k in batch}


def _train_matcher(config, coarse: bool, device="cuda"):
    exp = config.exp
    debug = bool(getattr(exp, "debug", False))
    group = DataGroup.current()
    rank, world = (0, 1) if group is None else (group.rank, group.world)
    check_matcher_config(config, world)
    device = resolve_device(device)
    np.random.seed(rank_seed(exp.seed, rank))
    if not getattr(config.data, "seed", None):
        config.data.seed = exp.seed
    config.gpu_num = world
    if getattr(config.optim, "adapt_lr", True):
        config.optim.lr, _ = config_adaptive_lr(config)
    else:
        config.optim.lr = config.optim.clr

    run_dir = init_config_odir(config, coarse)
    mlog = NullLogger()
    if rank == 0:
        run_dir.mkdir(parents=True, exist_ok=True)
        mlog = MetricsLogger(run_dir)
        mlog.log_text("config", str(namespace2dict(config)))
    logger.info(f"Run dir: {run_dir} (device {device}, rank {rank} of "
                f"{world})")

    model = build_matcher(config, coarse,
                          torch.Generator().manual_seed(exp.seed))
    init_imagenet_backbone(model, config.model)
    load_pretrained(model, config.model)
    replicate_params(model.to(device))
    opt = init_optimizer(config.optim, trainable_parameters(model))
    lr_sched = make_lr_schedule(config.optim)
    gen = torch.Generator(device).manual_seed(exp.seed)
    stepper = (CoarseTrainStep if coarse else C2FTrainStep)(
        model, opt, generator=gen, group=group)
    keys = BATCH_KEYS if coarse else C2F_KEYS
    workers = int(getattr(exp, "num_workers", 0) or 0)
    train_loader = init_data_loader(config.data, exp.batch_size, split="train",
                                    num_workers=workers)
    val_loader = init_data_loader(config.data, split="val", debug=debug,
                                  num_workers=workers)

    start_epoch, best_loss, best_tmed = 0, np.inf, np.inf
    ckpt_dir = run_dir / "checkpoints"
    last = latest_checkpoint(ckpt_dir, name="last")
    if last is not None:
        meta = load_checkpoint(last, model, opt)
        start_epoch = int(meta.get("step", 0))
        best_loss = float(meta.get("best_loss", np.inf))
        best_tmed = float(meta.get("best_tmed", np.inf))
        logger.info(f"Resumed from {last} at epoch {start_epoch} "
                    f"(best_loss={best_loss:.4g} best_tmed={best_tmed:.4g})")

    rthres = getattr(config.model, "rthres", 1)
    coarse_only_epochs = int(getattr(config.optim, "coarse_only_epochs", 0) or 0)
    max_steps = 5 if debug else None
    for epoch in range(start_epoch, exp.max_epochs):
        if lr_sched is not None:
            set_lr(opt, lr_sched(epoch))
        kw = {} if coarse else {"coarse_only": epoch < coarse_only_epochs}
        agg = []
        t0 = time.perf_counter()
        for i, batch in enumerate(train_loader):
            if max_steps and i >= max_steps:
                break
            metrics = stepper.step(to_device(batch, keys, device), **kw)
            agg.append(metrics["loss"])         # on the device: no sync
            if i % 50 == 0:
                mlog.log_scalars(epoch * 100000 + i,
                                 {k: float(v) for k, v in metrics.items()},
                                 prefix="train/neum_")
        mean = float(torch.stack(agg).mean()) if agg else float("nan")
        # Wall time per step, the loader's batches included (the mean above
        # waited for the device).
        step_ms = (time.perf_counter() - t0) / max(len(agg), 1) * 1e3
        mlog.log_scalars(epoch, {"ms_per_step": step_ms}, prefix="train/")
        logger.info(f"epoch {epoch}: loss={mean:.4f} lr={get_lr(opt):.2e} "
                    f"{step_ms:.1f} ms/step")

        if (epoch + 1) % getattr(exp, "check_epochs", 1) == 0:
            val_agg, r_errs, t_errs = {}, [], []
            for vi, batch in enumerate(val_loader):
                if debug and vi >= 2:
                    break
                if vi % world != rank:      # the ranks split the val set
                    continue
                vm, out = stepper.val_forward(to_device(batch, keys, device),
                                              **kw)
                for k, v in vm.items():
                    val_agg.setdefault(k, []).append(float(v))
                pose_m = eval_batch_pose(model, batch, out, rthres=rthres)
                r_errs += pose_m["R_err"]
                t_errs += pose_m["t_err"]
            # One gather of every rank's results, whatever each rank saw
            # (a rank may have had no validation batch), merged in rank
            # order.
            parts = all_gather_host([(val_agg, r_errs, t_errs)])
            val_agg, r_errs, t_errs = {}, [], []
            for agg_r, r_r, t_r in parts:
                for k, v in agg_r.items():
                    val_agg.setdefault(k, []).extend(v)
                r_errs += r_r
                t_errs += t_r
            t_arr, r_arr = np.asarray(t_errs, np.float64), np.asarray(r_errs)
            tmed = float(np.median(t_arr)) if len(t_arr) else np.inf
            val_m = {"tmed": tmed,
                     "Rmed": float(np.median(r_arr)) if len(r_arr) else np.inf,
                     "tmean": float(np.mean(t_arr[~np.isinf(t_arr)]))
                     if len(t_arr) else np.inf}
            mlog.log_scalars(epoch, val_m, prefix="hp/neum_")
            val_losses = {k: _finite_mean(v) for k, v in val_agg.items()}
            mlog.log_scalars(epoch, val_losses, prefix="val/neum_")
            val_loss = val_losses.get("loss", np.inf)
            logger.info(f"epoch {epoch}: val {val_m} loss={val_loss:.4f}")
            if val_loss < best_loss:
                best_loss = val_loss
                if rank == 0:
                    save_checkpoint(ckpt_dir, epoch + 1, model, opt, config,
                                    name="best", keep=1)
            if tmed < best_tmed:
                best_tmed = tmed
                if rank == 0:
                    save_checkpoint(ckpt_dir, epoch + 1, model, opt, config,
                                    name="best_tmed", keep=1)
        if rank == 0:
            save_checkpoint(ckpt_dir, epoch + 1, model, opt, config,
                            name="last", keep=1,
                            extra={"best_loss": float(best_loss),
                                   "best_tmed": float(best_tmed)})
        if group is not None:
            group.barrier()
    mlog.close()
    return config, model


def train_coarse(config, device="cuda"):
    return _train_matcher(config, coarse=True, device=device)


def train_c2f(config, device="cuda"):
    return _train_matcher(config, coarse=False, device=device)
