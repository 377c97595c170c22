"""Per-scene NeRF training (counterpart of
``nerfmatch_tpu/train/nerf_trainer.py``).

0.5 * (coarse + fine) MSE with the mip-NeRF 360 distortion regularizer,
per-epoch full-image validation renders, best / last checkpoints on val
PSNR, resume from the latest ``last`` checkpoint, deterministic run
directories.  One process on one device.  The route (``NerfTrainer.route``,
logged by :func:`train` and written to ``route.txt`` in the run dir) is a
function of the config, decided before any launch, as the JAX trainer
decides its own: ``"kernels"`` -- :meth:`NerfRenderer.train_render` (the
train-render and resample kernels on CUDA, their plain versions on the
CPU) -- on CUDA, or on the CPU with ``render.use_fused_train``, where
``NerfRenderer.fused_eval_supported`` holds and the NeRF has no
scene-coordinate head (``data.out_scr``); else ``"plain"`` --
``render_rays(train=True)`` on the rays' device (a classic or no-viewdir
NeRF, an ``out_scr`` NeRF, sample counts other than 128).  Random draws
come from a ``torch.Generator`` seeded with ``exp.seed``; ray batches from
``np.random.default_rng(exp.seed)`` as in the JAX trainer.  An appearance
NeRF (``embedding.appearance_embed``) holds one table row per training
sequence; each ray trains its sequence's row (the batch's ``ts``), and Adam
updates the table with the MLPs.  A retrieval-pair val sample (with
``data.train_pair_txt``) is scored by :meth:`NerfTrainer.validate_pair`.

Not ported: multi-device data parallelism (``exp.gpus > 1`` raises
``NotImplementedError``; ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import namespace2dict
from ..data.loaders import init_data_loader
from ..nerf.renderer import NerfRenderer
from ..utils import get_logger, resolve_device
from ..utils.metrics import (compute_nerf_metrics,
                             compute_nerf_pose_metrics, mse2psnr)
from ..utils.images import colorize_depth
from ..utils.optim import get_lr, init_optimizer, make_lr_schedule, set_lr
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .logging import MetricsLogger

logger = get_logger(level="INFO", name="nerf_trainer")


def parse_optim_tag(config):
    tag = f"{config.optimizer}"
    if config.weight_decay > 0:
        tag += f"wd{config.weight_decay}"
    if config.lr_scheduler == "steplr":
        if getattr(config, "decay_per_step", None):
            tag += f"sp{config.decay_per_step}-{config.decay_gamma}"
        elif getattr(config, "decay_step", None):
            tag += f"sp{'-'.join(map(str, config.decay_step))}-{config.decay_gamma}"
    if config.lr_scheduler == "cosine":
        tag += "cosine"
    return tag


def init_config_odir(config):
    """Deterministic experiment naming encoding data/model/optim params."""
    data = config.data
    data_tag = f"{data.scene}_wh{data.img_wh[0]}-{data.img_wh[1]}"
    if getattr(data, "max_sample_num", None):
        data_tag += f"_max{data.max_sample_num}"
    emb = config.embedding
    model_tag = f"{getattr(emb, 'type', 'normal')}_xyz{emb.xyz_num_freqs}"
    if getattr(emb, "appearance_embed", False):
        model_tag += "_app"
    exp = config.exp
    config.optim.max_epochs = exp.max_epochs
    prefix = getattr(exp, "prefix", "")
    if getattr(exp, "debug", False):
        prefix = "debug"
    optim_tag = (f"lr{config.optim.lr}b{exp.batch_size}"
                 f"{parse_optim_tag(config.optim)}_ep{exp.max_epochs}")
    exp.name = "/".join(x for x in [prefix, data_tag, model_tag, optim_tag] if x)
    exp.resume_version = getattr(exp, "resume_version", "version_0")
    exp.odir = str(exp.odir)
    return Path(exp.odir) / exp.name / exp.resume_version


def check_train_config(config):
    """Raise for training configs the port does not implement."""
    exp = getattr(config, "exp", None)
    if int(getattr(exp, "gpus", 0) or 0) > 1:
        raise NotImplementedError("multi-GPU NeRF training is not ported "
                                  "(ROADMAP: Queue 1, item 10)")


class NerfTrainer:
    """Holds the renderer (the trained parameters, the appearance table
    included), the optimizer and the LR schedule; :meth:`train_step` is one
    optimizer step.  ``num_frames``: the table's rows (the training
    sequences), for an appearance NeRF."""

    def __init__(self, config, device="cuda", seed: int = 0,
                 num_frames: int | None = None):
        check_train_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.renderer = NerfRenderer(config, num_frames=num_frames)
        self.renderer.init_params(torch.Generator().manual_seed(seed))
        self.renderer.to(self.device)
        self.opt = init_optimizer(config.optim, self.renderer.parameters())
        self.lr_sched = make_lr_schedule(config.optim)
        self.cnfg_loss = getattr(config, "loss", None)
        r = self.renderer
        self.use_fused = (self.device.type == "cuda" or bool(
            getattr(config.render, "use_fused_train", False))) \
            and r.fused_eval_supported and not r.cfg.out_scr
        self.route = "kernels" if self.use_fused else "plain"

    def render_train(self, rays, generator=None, draws=None, ray_id=None):
        if self.use_fused:
            return self.renderer.train_render(rays, generator, draws, ray_id)
        return self.renderer.render_rays(rays, train=True,
                                         generator=generator, draws=draws,
                                         ray_id=ray_id)

    def train_step(self, rays, rgbs, generator=None, mask=None, draws=None,
                   ts=None):
        """One optimizer step on a ray batch (tensors on the trainer's
        device; ``ts`` (N,): each ray's sequence, its appearance row) ->
        detached metrics."""
        preds = self.render_train(rays, generator, draws, ts)
        metrics = compute_nerf_metrics(preds, rgbs, mask_loss=mask,
                                       cnfg_loss=self.cnfg_loss)
        self.opt.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def validate_pair(self, sample, ds: int = 8):
        """Pair-based pose validation (JAX ``validate_pair``): render both
        images of a retrieval pair on the ds grid through ``predict`` (the
        eval kernels on CUDA; an appearance NeRF with row 1, as the JAX
        plain render) and score the depth- and match-based poses
        (``compute_nerf_pose_metrics``) -> metrics."""
        rays = np.asarray(sample["rays"]).reshape(-1, 12)
        w, h = [int(x) for x in np.asarray(sample["img_wh"]).reshape(-1)[:2]]
        n_img = len(rays) // 2
        grid_idx = (np.arange(h // ds)[:, None] * w * ds
                    + np.arange(w // ds)[None, :] * ds
                    + (ds // 2) * w + ds // 2).reshape(-1)
        idx = np.concatenate([grid_idx, n_img + grid_idx])
        preds = self.renderer.predict(torch.as_tensor(rays[idx],
                                                      device=self.device))
        return compute_nerf_pose_metrics(preds["pts_fine"].cpu().numpy(),
                                         preds["feat_fine"].cpu().numpy(),
                                         sample, ds=ds)

    @torch.no_grad()
    def validate_image(self, sample, max_rays: int | None = None):
        """Render one full val image through ``predict`` (the eval kernels
        on CUDA; an appearance NeRF with the sample's sequence row) ->
        (metrics, preds as numpy)."""
        rays = np.asarray(sample["rays"]).reshape(-1, 12)[:max_rays]
        rgbs = np.asarray(sample["rgbs"]).reshape(-1, 3)[:max_rays]
        w, h = [int(x) for x in np.asarray(sample["img_wh"]).reshape(-1)[:2]]
        ray_id = None
        if self.renderer.cfg.appearance_embedding:
            ray_id = torch.full((len(rays),), int(np.asarray(
                sample["seq_ind"]).flat[0]), dtype=torch.long,
                device=self.device)
        preds = self.renderer.predict(torch.as_tensor(rays, device=self.device),
                                      ray_id=ray_id)
        out, m = {}, {}
        for k, v in preds.items():
            v = v.cpu().numpy()
            if k.startswith(("rgb_", "depth_")) and v.shape[0] == h * w:
                v = v.reshape(h, w, -1)
            out[k] = v
        for stage in ("coarse", "fine"):
            key = f"rgb_{stage}"
            if key in out:
                mse_v = float(np.mean((out[key].reshape(-1, 3) - rgbs) ** 2))
                m[f"rgb_{stage}_psnr"] = float(mse2psnr(mse_v))
        return m, out


def train(config, device="cuda"):
    """The training loop behind the CLI -> (config, renderer); on the card
    unless ``device="cpu"``."""
    exp = config.exp
    debug = bool(getattr(exp, "debug", False))
    check_train_config(config)
    device = resolve_device(device)
    np.random.seed(exp.seed)

    run_dir = init_config_odir(config)
    run_dir.mkdir(parents=True, exist_ok=True)
    mlog = MetricsLogger(run_dir)
    mlog.log_text("config", str(namespace2dict(config)))
    logger.info(f"Run dir: {run_dir} (device {device})")

    train_set = init_data_loader(config.data, split="train").dataset
    val_loader = init_data_loader(config.data, split="val", debug=debug)
    # Before the resume: a stored table has this many rows.
    num_frames = int(np.max(train_set.seq_ind)) + 1
    trainer = NerfTrainer(config, device=device, seed=exp.seed,
                          num_frames=num_frames)
    mlog.log_text("route", trainer.route)
    logger.info(f"train route: {trainer.route}")

    start_epoch, best_psnr = 0, -np.inf
    ckpt_dir = run_dir / "checkpoints"
    last = latest_checkpoint(ckpt_dir, name="last")
    if last is not None:
        meta = load_checkpoint(last, trainer.renderer, trainer.opt)
        start_epoch = int(meta.get("step", 0))
        # Keep the best-so-far score across resumes.
        best_psnr = float(meta.get("best_psnr", -np.inf))
        logger.info(f"Resumed from {last} at epoch {start_epoch} "
                    f"(best_psnr={best_psnr:.3f})")

    gen = torch.Generator(device).manual_seed(exp.seed)
    rng = np.random.default_rng(exp.seed)
    use_mask = bool(getattr(getattr(config, "loss", None), "use_sem_mask",
                            False))
    max_steps = 10 if debug else None
    tensor = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,
                                                         device=device)
    for epoch in range(start_epoch, exp.max_epochs):
        if trainer.lr_sched is not None:
            set_lr(trainer.opt, trainer.lr_sched(epoch))
        agg = []
        for i, batch in enumerate(train_set.ray_batches(exp.batch_size, rng)):
            if max_steps and i >= max_steps:
                break
            mask = tensor(batch["mask"]) if use_mask and "mask" in batch \
                else None
            metrics = trainer.train_step(
                tensor(batch["rays"]), tensor(batch["rgbs"]), gen, mask,
                ts=tensor(batch["ts"], torch.long))
            if i % getattr(exp, "log_step", 100) == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["lr"] = get_lr(trainer.opt)
                mlog.log_scalars(epoch * 10000 + i, host, prefix="train/")
            # Stay on the device: a float() here would sync every step.
            agg.append(metrics["rgb_fine_psnr"])
        psnr_train = float(torch.stack(agg).mean()) if agg else float("nan")
        logger.info(f"epoch {epoch}: train psnr={psnr_train:.2f} "
                    f"lr={get_lr(trainer.opt):.2e}")

        if (epoch + 1) % getattr(exp, "check_epochs", 1) == 0:
            val_ms = []
            for vi, sample in enumerate(val_loader):
                if debug and vi >= 1:
                    break
                sample = {k: (v[0] if isinstance(v, (np.ndarray, list)) else v)
                          for k, v in sample.items()}
                if "c2w" in sample and np.asarray(sample["c2w"]).size == 32:
                    # Retrieval-pair val sample -> pose metrics, no image.
                    m, preds = trainer.validate_pair(sample), {}
                else:
                    m, preds = trainer.validate_image(sample)
                val_ms.append(m)
                if vi < getattr(exp, "log_num_max", 4):
                    if np.ndim(preds.get("rgb_fine")) == 3:
                        mlog.log_image(epoch, f"val/rgb_fine_{vi}",
                                       preds["rgb_fine"])
                    for stage in ("coarse", "fine"):
                        dk = f"depth_{stage}"
                        if np.ndim(preds.get(dk)) == 3:
                            mlog.log_image(epoch, f"val/depth_{stage}_{vi}",
                                           colorize_depth(preds[dk][..., 0]))
            keys = sorted({k for m in val_ms for k in m})
            val_mean = {k: float(np.mean([m[k] for m in val_ms if k in m]))
                        for k in keys}
            mlog.log_scalars(epoch, val_mean, prefix="val/")
            logger.info(f"epoch {epoch}: val {val_mean}")
            psnr_v = val_mean.get("rgb_fine_psnr", -np.inf)
            if psnr_v > best_psnr:
                best_psnr = psnr_v
                save_checkpoint(ckpt_dir, epoch + 1, trainer.renderer,
                                trainer.opt, config, name="best", keep=3,
                                extra={"val_psnr": psnr_v})
        save_checkpoint(ckpt_dir, epoch + 1, trainer.renderer, trainer.opt,
                        config, name="last", keep=1,
                        extra={"best_psnr": float(best_psnr)})
    mlog.close()
    return config, trainer.renderer
