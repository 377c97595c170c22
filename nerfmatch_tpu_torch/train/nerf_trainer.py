"""Per-scene mip-NeRF training (counterpart of
``nerfmatch_tpu/train/nerf_trainer.py``).

0.5 * (coarse + fine) MSE with the mip-NeRF 360 distortion regularizer,
per-epoch full-image validation renders, best / last checkpoints on val
PSNR, resume from the latest ``last`` checkpoint, deterministic run
directories.  One process on one device: CUDA rays go through
:meth:`NerfRenderer.train_render` (the train-render and resample kernels);
CPU rays go through the plain path (the kernels' plain versions when
``render.use_fused_train``, else ``render_rays(train=True)``).  Random draws
come from a ``torch.Generator`` seeded with ``exp.seed``; ray batches from
``np.random.default_rng(exp.seed)`` as in the JAX trainer.

Not ported: multi-device data parallelism (``exp.gpus > 1``), appearance
embeddings, the scene-coordinate head (``out_scr``) and retrieval-pair pose
validation (``validate_pair``); each raises ``NotImplementedError``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import namespace2dict
from ..data.loaders import init_data_loader
from ..nerf.renderer import NerfRenderer
from ..utils import get_logger, resolve_device
from ..utils.metrics import compute_nerf_metrics, mse2psnr
from ..utils.optim import get_lr, init_optimizer, make_lr_schedule, set_lr
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .logging import MetricsLogger, colorize_depth

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
                                  "(ROADMAP: multi-GPU training)")
    if getattr(getattr(config, "data", None), "out_scr", False):
        raise NotImplementedError("out_scr (scene-coordinate head) is not "
                                  "ported (ROADMAP: training slice)")
    if getattr(config.embedding, "appearance_embed", False):
        raise NotImplementedError(
            "appearance embeddings are not ported (ROADMAP: Cambridge "
            "appearance path, extras_grad)")


class NerfTrainer:
    """Holds the renderer (the trained parameters), the optimizer and the
    LR schedule; :meth:`train_step` is one optimizer step."""

    def __init__(self, config, device="cuda", seed: int = 0):
        check_train_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.renderer = NerfRenderer(config)
        self.renderer.init_params(torch.Generator().manual_seed(seed))
        self.renderer.to(self.device)
        self.opt = init_optimizer(config.optim, self.renderer.parameters())
        self.lr_sched = make_lr_schedule(config.optim)
        self.cnfg_loss = getattr(config, "loss", None)
        self.use_fused = self.device.type == "cuda" or bool(
            getattr(config.render, "use_fused_train", False))

    def render_train(self, rays, generator=None, draws=None):
        if self.use_fused:
            return self.renderer.train_render(rays, generator, draws)
        return self.renderer.render_rays(rays, train=True,
                                         generator=generator, draws=draws)

    def train_step(self, rays, rgbs, generator=None, mask=None, draws=None):
        """One optimizer step on a ray batch (tensors on the trainer's
        device) -> detached metrics."""
        preds = self.render_train(rays, generator, draws)
        metrics = compute_nerf_metrics(preds, rgbs, mask_loss=mask,
                                       cnfg_loss=self.cnfg_loss)
        self.opt.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    def validate_pair(self, sample, ds: int = 8):
        raise NotImplementedError("retrieval-pair pose validation is not "
                                  "ported (ROADMAP: validate_pair)")

    @torch.no_grad()
    def validate_image(self, sample, max_rays: int | None = None):
        """Render one full val image through ``predict`` (the eval kernels
        on CUDA) -> (metrics, preds as numpy)."""
        rays = np.asarray(sample["rays"]).reshape(-1, 12)[:max_rays]
        rgbs = np.asarray(sample["rgbs"]).reshape(-1, 3)[:max_rays]
        w, h = [int(x) for x in np.asarray(sample["img_wh"]).reshape(-1)[:2]]
        preds = self.renderer.predict(torch.as_tensor(rays, device=self.device))
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
    trainer = NerfTrainer(config, device=device, seed=exp.seed)

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
            metrics = trainer.train_step(tensor(batch["rays"]),
                                         tensor(batch["rgbs"]), gen, mask)
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
                    trainer.validate_pair(sample)
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
