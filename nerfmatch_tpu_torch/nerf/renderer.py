"""Hierarchical NeRF renderer (counterpart of
``nerfmatch_tpu/nerf/renderer.py``): mip-NeRF (IPE, conical frustums) or
the classic NeRF (Fourier features, stratified and inverse-CDF samples),
with or without viewdirs, with or without the scene-coordinate head
(``data.out_scr``).

``NerfRenderer`` is an ``nn.Module`` holding ``nerf_coarse`` / ``nerf_fine``
and, with ``embedding.appearance_embed``, the per-sequence appearance table
``embedding_a`` (V, 16) (the reference's state-dict keys).  Every render
takes ``ray_id`` (N,), the table row of each ray (default 1, as the JAX
package), clamped to ``V - 1`` as a JAX gather clamps; the row joins the
views layer only.  Routing follows the device of the rays and, on the
card, :attr:`NerfRenderer.fused_eval_supported` (the JAX predicate of the
same name without its backend test), a function of the config alone:

* eval, CUDA, the predicate holds: :meth:`fused_render` -- the render
  kernel twice (coarse, fine) with the resample kernel between them
  (``make_fused_hierarchical`` semantics, including the unit-direction
  reparameterization and the int8 trunk of ``cfg.trunk_int8``, with
  activation scales calibrated lazily from the first ray batch, and
  ``feat_comb='max'``: the fine stage's descriptor and point of each ray's
  largest weight).  The kernels read the trunk and the heads; a
  scene-coordinate head is not rendered (validation drops it too).
* eval, CPU, or CUDA where the predicate fails (a classic or no-viewdir
  NeRF, a ``"viewdir"`` descriptor, a final-layer tap on a skip layer,
  sample counts other than 128): :meth:`render_rays` in chunks, the plain
  sampling / MLP / compositing path with the MLP in ``compute_dtype``
  (``render_rays(train=False, ret_pfeat=True, validation=True)``), the JAX
  package's XLA route, which serves ``'none'``.
* training: :meth:`train_render` (``make_fused_train_hierarchical``) --
  jittered fenceposts, the train-render kernels (forward and backward) per
  stage with the randomized resample kernel between them, both stages
  reading the rays' appearance rows; on CPU tensors through the kernels'
  plain versions.  :meth:`render_rays` with ``train=True`` is the plain f32
  (or ``compute_dtype``) training path.  Both gather the rows under
  autograd, so the table gets its gradient from PyTorch's index backward
  (the gather's VJP, which JAX runs in XLA).  ``NerfTrainer`` takes
  :meth:`render_rays` instead where the JAX trainer leaves its fused path:
  a config the predicate rejects, or an ``out_scr`` NeRF, whose training
  render adds ``scr_{stage}`` (the point at the detached depth minus the
  composited head channels).

Random draws come from an explicit ``torch.Generator`` or as tensors
(:meth:`train_draws`), so a test can feed both packages the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..models.layers import init_params_
from ..ops.kernels.quant import calibrate_act_scales, pack_mlp_int8
from ..ops.kernels.render_kernel import (APP_DIM, TILE_RAYS,
                                         kernel_forms_descriptor, pack_stage,
                                         render_stage)
from ..ops.kernels.render_train_kernel import StageSpec, render_train
from ..ops.kernels.resample_kernel import resample_z
from ..utils.geometry import unnormalize_pts
from .compositing import composite_features, t_to_s, volume_render
from .embedding import (fourier_embedding, fourier_embedding_dim,
                        ipe_embedding, ipe_embedding_dim, pe_embedding)
from .model import NerfConfig, NerfMLP, eval_feat_layer
from .rays import RAY_VIEWDIR, sample_nerf_rays
from .sampling import (jitter_fenceposts, jitter_uniforms,
                       resample_z_from_weights, sample_along_rays,
                       stratified_u)


# int8 mode of the localization serving paths (scene-point cache and the
# localize-time re-render) when the config does not set render.trunk_int8:
# the JAX package's gated serving default (nerfmatch_tpu/nerf/renderer.py).
SERVING_INT8_DEFAULT = "coarse"
INT8_MODES = ("none", "coarse", "both", "posttap")


def serving_int8_mode(config) -> str:
    """The int8 mode of the serving paths: an explicit ``render.trunk_int8``
    (``'none'`` included) wins; an absent key means
    :data:`SERVING_INT8_DEFAULT`."""
    mode = getattr(getattr(config, "render", None), "trunk_int8", None)
    return SERVING_INT8_DEFAULT if mode is None else mode


def batch_range(z, group=None):
    """(min, max) of ``z`` over the batch; with a data-parallel ``group``
    over the global batch."""
    lo, hi = z.min(), z.max()
    return (lo, hi) if group is None else (group.amin(lo), group.amax(hi))


def reparam_unit_dir(rays):
    """Rescale packed rays to the unit-direction parameterization of the
    fused kernels (``render_kernel.py: reparam_unit_dir``) -> (rays', nrm);
    kernel depths are ``nrm`` times the plain path's."""
    nrm = torch.sqrt(torch.sum(rays[:, 3:6] ** 2, dim=-1, keepdim=True))
    nrm = torch.clamp(nrm, min=1e-12)
    nrm = torch.where(torch.abs(nrm - 1.0) < 1e-5, torch.ones_like(nrm), nrm)
    rays = torch.cat([rays[:, :6], rays[:, 6:8] * nrm, rays[:, 8:11],
                      rays[:, 11:12] / nrm], dim=-1).contiguous()
    return rays, nrm


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    embed_type: str = "mip"
    xyz_num_freqs: int = 15
    dirs_num_freqs: int = 4
    use_viewdirs: bool = True
    use_disp: bool = False
    white_bg: bool = False
    single_model: bool = False
    appearance_embedding: bool = False
    mip_var_scale: float = -1.0
    feat_comb: str = "lin"
    output_dim: int = 4
    early_term_eps: float = 1e-4
    trunk_int8: str = "none"
    perturb: bool = True
    noise_std: float = 1.0
    compute_dtype: str = "float32"
    out_scr: bool = False
    num_out_ch: int = 0      # the scene-coordinate channels (out_scr)

    @classmethod
    def from_config(cls, config):
        render, emb = config.render, config.embedding
        data = getattr(config, "data", None)
        return cls(
            embed_type=getattr(emb, "type", "normal"),
            xyz_num_freqs=emb.xyz_num_freqs,
            dirs_num_freqs=getattr(emb, "dirs_num_freqs", 4),
            use_viewdirs=render.use_viewdirs,
            use_disp=bool(getattr(render, "use_disp", False)),
            white_bg=render.white_bg or bool(getattr(data, "white_bg", False)),
            single_model=bool(getattr(render, "single_model", False)),
            appearance_embedding=bool(getattr(emb, "appearance_embed", False)),
            mip_var_scale=getattr(emb, "mip_var_scale", -1),
            feat_comb=getattr(render, "feat_comb", "lin"),
            output_dim=getattr(getattr(config, "fine_nerf", None),
                               "output_dim", 4),
            early_term_eps=getattr(render, "early_term_eps", 1e-4),
            # 'none' when absent, as the JAX RenderConfig; only the serving
            # paths resolve an absent key (serving_int8_mode).
            trunk_int8=getattr(render, "trunk_int8", None) or "none",
            perturb=bool(getattr(render, "perturb", True)),
            noise_std=float(getattr(render, "noise_std", 1.0)),
            compute_dtype=getattr(render, "compute_dtype", "float32"),
            out_scr=bool(getattr(data, "out_scr", False)),
            num_out_ch=3 if getattr(data, "out_scr", False) else 0,
        )


class NerfRenderer(nn.Module):
    def __init__(self, config, num_frames: int | None = None,
                 stop_layer: int = -1):
        """``num_frames``: rows of the appearance table (the sequences of
        the training set; read from a stored table by the loaders), used
        only with ``embedding.appearance_embed``."""
        super().__init__()
        self.cfg = RenderConfig.from_config(config)
        mip = self.cfg.embed_type == "mip"
        xyz_dim = (ipe_embedding_dim if mip else fourier_embedding_dim)(
            3, self.cfg.xyz_num_freqs)
        dirs_dim = 0
        if self.cfg.use_viewdirs:
            dirs_dim = (2 * 3 * self.cfg.dirs_num_freqs + 3 if mip else
                        fourier_embedding_dim(3, self.cfg.dirs_num_freqs))
        app_dim = APP_DIM if self.cfg.appearance_embedding else 0
        if app_dim:
            if not num_frames:
                raise ValueError("an appearance NeRF needs num_frames (the "
                                 "rows of its embedding_a table)")
            self.embedding_a = nn.Embedding(num_frames, app_dim)
        # As the JAX renderer: the head's mode is the config's out_scr.
        common = dict(use_viewdirs=self.cfg.use_viewdirs, xyz_dim=xyz_dim,
                      dirs_dim=dirs_dim, app_dim=app_dim,
                      out_3d_pnt=self.cfg.out_scr,
                      out_add_ch=self.cfg.num_out_ch)
        self.coarse_cfg = None
        if not self.cfg.single_model:
            self.coarse_cfg = NerfConfig.from_namespace(config.coarse_nerf,
                                                        **common)
            self.nerf_coarse = NerfMLP(self.coarse_cfg)
        self.fine_cfg = NerfConfig.from_namespace(
            config.fine_nerf, stop_layer=stop_layer, **common)
        self.nerf_fine = NerfMLP(self.fine_cfg)
        self.act_scales = None   # per-scene int8 scales (calibrate_int8)

    @property
    def device(self):
        return self.nerf_fine.pts_linears[0].weight.device

    def init_params(self, generator: torch.Generator):
        """Re-draw every weight and bias from ``generator``:
        U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the distribution of
        ``nerf/model.py: init_nerf_params`` (its draws differ), and the
        appearance table N(0, 1), as the JAX ``init_params``."""
        init_params_(self, generator)
        if self.cfg.appearance_embedding:
            with torch.no_grad():
                w = self.embedding_a.weight
                w.copy_(torch.randn(w.shape, generator=generator))
        return self

    def app_rows(self, ray_id, n: int, device):
        """The appearance rows (n, 16) of ``ray_id`` (n,) int (None: every
        ray takes row 1, the JAX default), ids clamped to the table as a
        JAX gather clamps them; None without a table.  Differentiable in
        the table."""
        if not self.cfg.appearance_embedding:
            return None
        table = self.embedding_a.weight
        if ray_id is None:
            ray_id = torch.ones(n, dtype=torch.long, device=device)
        ray_id = torch.as_tensor(ray_id, device=table.device).long().reshape(-1)
        if ray_id.shape[0] != n:
            raise ValueError(f"ray_id has {ray_id.shape[0]} entries for {n} "
                             "rays")
        return table[ray_id.clamp(0, table.shape[0] - 1)].to(device)

    def _stages(self):
        coarse = self.nerf_fine if self.cfg.single_model else self.nerf_coarse
        return [("coarse", coarse), ("fine", self.nerf_fine)]

    # ------------------------------------------------------------------
    # Plain path
    # ------------------------------------------------------------------
    def encode_xyz(self, pts, var=None):
        """Sample encoding: the IPE of (means, vars) for a mip NeRF, else
        the Fourier features of the points."""
        if self.cfg.embed_type == "mip":
            return ipe_embedding(pts, var, self.cfg.xyz_num_freqs)[0]
        return fourier_embedding(pts, self.cfg.xyz_num_freqs)

    def encode_dirs(self, dirs):
        """Viewdir encoding: mip-style PE for a mip NeRF, else Fourier."""
        if self.cfg.embed_type == "mip":
            return pe_embedding(dirs, self.cfg.dirs_num_freqs)
        return fourier_embedding(dirs, self.cfg.dirs_num_freqs)

    def render_rays(self, rays, train: bool = False, generator=None,
                    draws=None, ray_id=None, group=None):
        """Hierarchical render of (R, 12) rays (or (R, 11), without the mip
        radius, for a classic NeRF) -> per-ray maps, the MLP in
        ``compute_dtype`` (as the JAX ``_forward_nerf``); ``ray_id``: the
        appearance rows (see :meth:`app_rows`).

        ``train=False``: the JAX ``render_rays(train=False, ret_pfeat=True,
        validation=True)``.  ``train=True``: the JAX XLA training render
        (a mip NeRF always randomized: jittered coarse fenceposts,
        stratified resample; a classic NeRF where ``perturb``: jittered
        strata, uniform inverse-CDF draws; density noise when
        ``noise_std > 0``) -> rgb / depth per stage, ``weights_fine``,
        ``s_fine`` and, for an ``out_scr`` NeRF, ``scr_{stage}``.  Draws
        come from ``draws`` (see :meth:`train_draws`, per stage) or
        ``generator``; with a data-parallel ``group`` the rays are this
        rank's block of the global batch (see :meth:`rank_draws`; ``s_fine``
        takes the global batch's z range)."""
        cfg = self.cfg
        mip = cfg.embed_type == "mip"
        rays_d = rays[..., 3:6]
        viewdirs = rays[..., RAY_VIEWDIR] if rays.shape[-1] >= 11 else rays_d
        extra = []
        if cfg.use_viewdirs:
            extra.append(self.encode_dirs(viewdirs))
        app = self.app_rows(ray_id, rays.shape[0], rays.device)
        if app is not None:
            extra.append(app)
        extra = torch.cat(extra, dim=-1) if extra else None
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        if train and draws is None:
            draws = self.rank_draws(rays.shape[0], generator, rays.device,
                                    group, randomized=True if mip else None)
        preds = {}
        z_vals = weights = None
        for stage, mlp in self._stages():
            rand = noise = None
            if train:
                rand = draws.get("t_rand" if stage == "coarse" else "u")
                noise = draws.get(f"noise_{stage}")
            pts, z_vals = sample_along_rays(
                rays, num_pts=mlp.cfg.num_pts, z_vals=z_vals, weights=weights,
                model_type=stage, scale_var=cfg.mip_var_scale, rand=rand,
                embed_type=cfg.embed_type, use_disp=cfg.use_disp)
            pts, var = pts if mip else (pts, None)
            inputs = self.encode_xyz(pts, var)
            if extra is not None:
                inputs = torch.cat([inputs, extra[:, None, :].expand(
                    -1, inputs.shape[1], -1)], -1)
            raw, feats = mlp(inputs, dtype=dtype, val=not train)
            rendered = volume_render(
                raw[..., :cfg.output_dim + cfg.num_out_ch + 3], z_vals, rays_d,
                white_bg=cfg.white_bg, input_dim=cfg.output_dim, noise=noise,
                mip=mip, out_last=cfg.num_out_ch > 0)
            weights = rendered["weights"]
            if train:
                if cfg.out_scr:
                    preds[f"scr_{stage}"] = (
                        rays[:, :3] + rays_d * rendered["depth"].detach()[:, None]
                        - rendered["last"])
                if stage == "fine":
                    # Batch-global min/max, as the reference
                    # (renderer.py:320-327).
                    preds["s_fine"] = t_to_s(z_vals,
                                             *batch_range(z_vals, group))
                    preds["weights_fine"] = weights
            else:
                preds[f"feat_{stage}"] = composite_features(
                    weights, feats, cfg.feat_comb)
                preds[f"pts_{stage}"] = composite_features(
                    weights, pts, cfg.feat_comb)
            preds[f"rgb_{stage}"] = rendered["rgb"]
            preds[f"depth_{stage}"] = rendered["depth"]
        return preds

    # ------------------------------------------------------------------
    # Training render (train-render + resample kernels)
    # ------------------------------------------------------------------
    def train_draws(self, n: int, generator=None, device=None,
                    randomized: bool | None = None):
        """The random numbers of one training render of ``n`` rays, drawn
        in a fixed order from ``generator``: ``t_rand`` (fencepost or
        stratum jitter) and ``u`` (the resample's draw: stratified for a
        mip NeRF, uniform for a classic one) when randomized (default
        ``cfg.perturb``), then ``noise_coarse`` / ``noise_fine`` (already
        scaled by ``noise_std``) when ``noise_std > 0``.  Shapes, with S_c
        and S_f the stages' sample counts: mip (n, S_c+1) draws and (n,
        S_c) noise for both stages; classic (n, S_c) and (n, S_f) draws,
        (n, S_c) and (n, S_c + S_f) noise."""
        cfg = self.cfg
        (_, cmlp), (_, fmlp) = self._stages()
        S_c, S_f = cmlp.cfg.num_pts, fmlp.cfg.num_pts
        mip = cfg.embed_type == "mip"
        randomized = cfg.perturb if randomized is None else randomized
        out = {}
        if randomized and mip:
            out["t_rand"] = jitter_uniforms(n, S_c + 1, generator, device)
            out["u"] = stratified_u(n, S_c + 1, generator, device)
        elif randomized:
            out["t_rand"] = jitter_uniforms(n, S_c, generator, device)
            out["u"] = jitter_uniforms(n, S_f, generator, device)
        if cfg.noise_std > 0:
            for stage, S in (("coarse", S_c),
                             ("fine", S_c if mip else S_c + S_f)):
                out[f"noise_{stage}"] = cfg.noise_std * torch.randn(
                    (n, S), generator=generator, device=device)
        return out

    def rank_draws(self, n: int, generator=None, device=None, group=None,
                   **kw):
        """:meth:`train_draws` of this rank's ``n`` rays: with a
        data-parallel ``group`` the global batch's draws (``n`` x the world
        size, from the generator every rank holds in the same state) cut to
        the rank's rows, so a step's draws do not depend on the world
        size."""
        if group is None:
            return self.train_draws(n, generator, device, **kw)
        draws = self.train_draws(n * group.world, generator, device, **kw)
        return {k: v[group.rows(n)] for k, v in draws.items()}

    def check_train_supported(self):
        """Raise where the JAX fused train factory asserts: coarse and fine
        MLPs of different layouts or sample counts."""
        (_, cm), (_, fm) = self._stages()
        if (cm.cfg.hid_dim, cm.cfg.layer_num, tuple(cm.cfg.skips),
                cm.cfg.num_pts) != (fm.cfg.hid_dim, fm.cfg.layer_num,
                                    tuple(fm.cfg.skips), fm.cfg.num_pts):
            raise NotImplementedError(
                "fused train needs coarse/fine NeRFs with identical MLP "
                "layouts and sample counts (render_train.py:515-518)")

    def _stage_spec(self, mlp):
        cfg = self.cfg
        return StageSpec(mlp, cfg.xyz_num_freqs, cfg.dirs_num_freqs,
                         cfg.mip_var_scale if cfg.mip_var_scale > 0 else 1.0,
                         cfg.white_bg)

    def train_render(self, rays, generator=None, draws=None, ray_id=None,
                     group=None):
        """Two-stage training render of (N, 12) rays ->
        dict(rgb_coarse, rgb_fine, weights_fine, s_fine), differentiable in
        the MLP parameters and the appearance table
        (``make_fused_train_hierarchical``); ``ray_id``: the appearance rows
        (see :meth:`app_rows`), read by both stages; ``group``: see
        :meth:`render_rays`."""
        self.check_train_supported()
        (_, coarse_mlp), (_, fine_mlp) = self._stages()
        app = self.app_rows(ray_id, rays.shape[0], rays.device)
        rays, _ = reparam_unit_dir(rays)
        n, S = rays.shape[0], self.fine_cfg.num_pts
        if draws is None:
            draws = self.rank_draws(n, generator, rays.device, group)
        t = torch.linspace(0.0, 1.0, S + 1, device=rays.device)
        z = rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t
        if "t_rand" in draws:
            z = jitter_fenceposts(z, draws["t_rand"])
        z = z.contiguous()
        zeros = torch.zeros(n, S, device=rays.device)
        rgb_c, w_c = render_train(self._stage_spec(coarse_mlp), rays, z,
                                  draws.get("noise_coarse", zeros), app)
        z_f = resample_z(z, w_c.detach().contiguous(), u=draws.get("u"))
        rgb_f, w_f = render_train(self._stage_spec(fine_mlp), rays, z_f,
                                  draws.get("noise_fine", zeros), app)
        return {"rgb_coarse": rgb_c, "rgb_fine": rgb_f, "weights_fine": w_f,
                "s_fine": t_to_s(z_f, *batch_range(z_f, group))}

    # ------------------------------------------------------------------
    # Fused path (render + resample kernels)
    # ------------------------------------------------------------------
    @property
    def fused_eval_supported(self) -> bool:
        """Whether the eval kernels render this config (the JAX
        ``NerfRenderer.fused_eval_supported`` without its backend test): a
        mip NeRF with viewdirs, 128 samples in both stages, a descriptor
        that is a trunk activation (not the views layer's of a
        ``"viewdir"`` head) and not a final-layer tap on a skip layer (the
        plain path's descriptor there is the post-concat state, which the
        kernel never forms).  A pure function of the config: serving,
        evaluation and training route by it before any launch."""
        fine = self.fine_cfg
        return (self.cfg.embed_type == "mip" and self.cfg.use_viewdirs
                and kernel_forms_descriptor(fine) and fine.num_pts == 128
                and (self.coarse_cfg or fine).num_pts == 128)

    def check_fused_supported(self):
        """Raise for configs the CUDA kernels do not implement."""
        cfg = self.cfg
        if cfg.feat_comb not in ("lin", "max"):
            raise ValueError(f"feat_comb={cfg.feat_comb!r} not in ('lin', "
                             "'max')")
        if cfg.trunk_int8 not in INT8_MODES:
            raise ValueError(f"trunk_int8={cfg.trunk_int8!r} not in "
                             f"{INT8_MODES}")
        coarse_pts = (self.coarse_cfg or self.fine_cfg).num_pts
        if coarse_pts != self.fine_cfg.num_pts:
            raise NotImplementedError("fused render needs equal coarse and "
                                      "fine sample counts")

    def int8_plan(self):
        """(first int8 layer of the coarse stage, of the fine stage), None
        for a bf16 stage: ``cfg.trunk_int8`` as ``make_fused_hierarchical``
        maps it ('posttap' quantizes the fine trunk after the tap layer, and
        is 'coarse' when the tap is the last layer)."""
        mode = self.cfg.trunk_int8
        tap, last = eval_feat_layer(self.fine_cfg), self.fine_cfg.layer_num - 1
        fine = {"both": 0, "posttap": tap + 1 if tap < last else None}
        return (0 if mode in ("coarse", "both", "posttap") else None,
                fine.get(mode))

    def calibrate_int8(self, rays):
        """Per-scene int8 activation scales from a representative (N, 12)
        ray batch (``quant.calibrate_act_scales``).  The serving paths call
        it lazily with their first batch; call it to choose the set."""
        self.act_scales = calibrate_act_scales(self, rays)
        return self.act_scales

    def _ensure_int8_calibrated(self, rays):
        if self.cfg.trunk_int8 != "none" and self.act_scales is None:
            self.calibrate_int8(rays[:min(1024, rays.shape[0])])

    def pack_fused(self):
        """Kernel weights of both stages, ((weights, int8 trunk) of the
        coarse stage, the same of the fine stage): the int8 trunk where
        ``int8_plan`` quantizes, and on CUDA the render kernel's weights
        (``render_kernel.pack_stage``: the stage's MLP padded to the
        kernel's width once, its weights and int8 trunk packed from it)."""
        plan = self.int8_plan()
        if any(p is not None for p in plan) and self.act_scales is None:
            raise RuntimeError(
                f"render.trunk_int8={self.cfg.trunk_int8!r} needs per-scene "
                "activation scales: call calibrate_int8(rays) first "
                "(fused_predict and render_novel_views do it lazily)")
        cuda = self.device.type == "cuda"
        out = []
        for (name, mlp), start in zip(self._stages(), plan):
            tap = eval_feat_layer(mlp.cfg) if name == "fine" else None
            scales = None if start is None else self.act_scales[name]
            if cuda:
                out.append(pack_stage(mlp, scales, start, tap))
            else:
                out.append((None, None if start is None else pack_mlp_int8(
                    mlp, scales, start, tap)))
        return tuple(out)

    def _stage_kwargs(self):
        cfg = self.cfg
        return dict(num_freqs=cfg.xyz_num_freqs, dirs_freqs=cfg.dirs_num_freqs,
                    var_scale=cfg.mip_var_scale if cfg.mip_var_scale > 0
                    else 1.0, early_term_eps=cfg.early_term_eps,
                    white_bg=cfg.white_bg)

    def fused_render(self, rays, packed=None, ray_id=None, app=None):
        """Two-stage fused render of (N, 12) rays, N a multiple of
        ``TILE_RAYS``.  ``packed``: optional :meth:`pack_fused` output, to
        pack once for many chunks; ``ray_id``: the appearance rows (see
        :meth:`app_rows`), read by the fine stage's views layer, or ``app``
        the (N, 16) rows themselves.  The coarse stage emits no rgb, so the
        outputs hold ``rgb_fine`` only."""
        self.check_fused_supported()
        (_, coarse_mlp), (_, fine_mlp) = self._stages()
        (pc, qc), (pf, qf) = packed or self.pack_fused()
        if app is None:
            app = self.app_rows(ray_id, rays.shape[0], rays.device)
        rays, nrm = reparam_unit_dir(rays)
        S = self.fine_cfg.num_pts
        t = torch.linspace(0.0, 1.0, S + 1, device=rays.device)
        z_vals = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
        kw = self._stage_kwargs()
        coarse = render_stage(coarse_mlp, rays, z_vals, fine=False,
                              packed=pc, int8=qc, **kw)
        z_fine = resample_z(z_vals, coarse["weights"])
        fine = render_stage(fine_mlp, rays, z_fine, fine=True, packed=pf,
                            int8=qf, app=app,
                            feat_max=self.cfg.feat_comb == "max", **kw)
        inv = 1.0 / nrm[:, 0]
        return {"depth_coarse": coarse["depth"] * inv,
                "rgb_fine": fine["rgb"], "depth_fine": fine["depth"] * inv,
                "acc_fine": fine["acc"], "feat_fine": fine["feat"],
                "pts_fine": fine["pts"], "weights_fine": fine["weights"]}

    def fused_predict(self, rays, chunk_rays: int = 9216, ray_id=None):
        """Chunked :meth:`fused_render` over any number of rays; with an
        int8 mode the scales are calibrated from the first 1024 rays when
        there are none yet.  ``ray_id`` (N,): the appearance rows, padded
        with the last one, as the JAX ``fused_predict``."""
        n = rays.shape[0]
        if n == 0:
            raise ValueError("fused_predict: empty ray batch")
        self.check_fused_supported()
        self._ensure_int8_calibrated(rays)
        if not self.cfg.appearance_embedding:
            ray_id = None
        else:
            ray_id = (torch.ones(n, dtype=torch.long, device=rays.device)
                      if ray_id is None else torch.as_tensor(
                          ray_id, device=rays.device).long().reshape(-1))
        n_pad = (-n) % TILE_RAYS
        if n_pad:
            rays = torch.cat([rays, rays[-1:].expand(n_pad, -1)])
            if ray_id is not None:
                ray_id = torch.cat([ray_id, ray_id[-1:].expand(n_pad)])
        packed = self.pack_fused()
        chunk_rays -= chunk_rays % TILE_RAYS
        chunks = [self.fused_render(
            rays[i:i + chunk_rays].contiguous(), packed,
            None if ray_id is None else ray_id[i:i + chunk_rays])
            for i in range(0, rays.shape[0], chunk_rays)]
        return {k: torch.cat([c[k] for c in chunks])[:n] for k in chunks[0]}

    @torch.no_grad()
    def coarse_resample(self, rays, packed=None, plain: bool = False):
        """The no-gradient half of an iNeRF step
        (``nerfmatch_tpu/eval/inerf.py:71-90``): the coarse pass over (N, 12)
        rays at the fine stage's sample count with variance scale 1, then
        the resample of its weights -> fine fenceposts z (N, S+1).

        CUDA rays: the serving coarse stage (the render kernel, its int8
        trunk under an int8 mode, early termination at ``early_term_eps``)
        and the resample kernel, in :meth:`fused_render`'s unit-direction
        parameterization; ``packed``: :meth:`pack_fused`'s output.  CPU rays,
        or ``plain`` (a test's switch): the JAX iNeRF's own pass, the coarse
        MLP in ``compute_dtype`` and the plain resample."""
        S = self.fine_cfg.num_pts
        (_, coarse_mlp), _ = self._stages()
        if plain or rays.device.type != "cuda":
            (mean, var), z = sample_along_rays(rays, num_pts=S, scale_var=1.0)
            enc, _ = ipe_embedding(mean, var, self.cfg.xyz_num_freqs)
            dirs = pe_embedding(rays[:, RAY_VIEWDIR], self.cfg.dirs_num_freqs)
            app = self.app_rows(None, rays.shape[0], rays.device)
            if app is not None:     # row 1, as the JAX iNeRF; sigma ignores it
                dirs = torch.cat([dirs, app], dim=-1)
            raw, _ = coarse_mlp(
                torch.cat([enc, dirs[:, None, :].expand(-1, S, -1)], -1),
                dtype=torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                else None, val=True)
            weights = volume_render(raw, z, rays[:, 3:6])["weights"]
            return resample_z_from_weights(z, weights)
        self.check_fused_supported()
        (pc, qc), _ = packed or self.pack_fused()
        n = rays.shape[0]
        rays = torch.cat([rays, rays[-1:].expand((-n) % TILE_RAYS, -1)])
        rays, nrm = reparam_unit_dir(rays)
        t = torch.linspace(0.0, 1.0, S + 1, device=rays.device)
        z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
        coarse = render_stage(coarse_mlp, rays, z, fine=False, packed=pc,
                              int8=qc, **{**self._stage_kwargs(),
                                          "var_scale": 1.0})
        return (resample_z(z, coarse["weights"]) / nrm)[:n]

    def predict(self, rays, chunk_rays: int = 4096, ray_id=None):
        """Eval render: the fused kernels for CUDA rays where
        :attr:`fused_eval_supported` holds (outputs without
        ``rgb_coarse``), else the plain path in chunks of ``chunk_rays`` on
        the rays' device; ``ray_id`` (N,): the appearance rows (see
        :meth:`app_rows`)."""
        if rays.device.type == "cuda" and self.fused_eval_supported:
            return self.fused_predict(rays, ray_id=ray_id)
        rid = lambda i: None if ray_id is None else ray_id[i:i + chunk_rays]
        chunks = [self.render_rays(rays[i:i + chunk_rays], ray_id=rid(i))
                  for i in range(0, rays.shape[0], chunk_rays)]
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    # ------------------------------------------------------------------
    # Novel views (localization re-render)
    # ------------------------------------------------------------------
    def _view_rays(self, img_hw, K, c2w, unnorm_scene, downsample):
        H, W = img_hw
        c2w_n = np.linalg.inv(np.asarray(unnorm_scene, np.float64)) \
            @ np.asarray(c2w, np.float64)
        dev = self.device
        return sample_nerf_rays(
            H, W, torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                  device=dev),
            torch.as_tensor(c2w_n, dtype=torch.float32, device=dev),
            ds=downsample, embed_type=self.cfg.embed_type)

    @torch.no_grad()
    def render_novel_view(self, img_hw, K, c2w, unnorm_scene,
                          downsample: int = 8):
        """rgb + world-frame 3D points + NeRF features on the ds-grid at a
        world-frame pose ``c2w`` -> dict of numpy arrays."""
        out = self.render_novel_views(img_hw, [K], [c2w], [unnorm_scene],
                                      downsample)
        return {k: v[0] for k, v in out.items()}

    @torch.no_grad()
    def render_novel_views(self, img_hw, Ks, c2ws, unnorm_scenes,
                           downsample: int = 8):
        """Batched :meth:`render_novel_view`: all poses' rays in one
        :meth:`predict` call (the kernels, or the plain route where
        :attr:`fused_eval_supported` fails) -> (B, ...) numpy arrays; an
        appearance NeRF renders with table row 1, as the JAX package."""
        H, W = img_hw
        B = len(c2ws)
        rays = [self._view_rays(img_hw, Ks[b], c2ws[b], unnorm_scenes[b],
                                downsample) for b in range(B)]
        n = rays[0].shape[0]
        if rays[0].device.type == "cuda" and self.fused_eval_supported:
            # The JAX package calibrates from the first pose's rays.
            self._ensure_int8_calibrated(rays[0])
        preds = self.predict(torch.cat(rays))
        pts = preds["pts_fine"].reshape(B, n, 3)
        un = torch.as_tensor(np.stack([np.asarray(u) for u in unnorm_scenes]),
                             dtype=torch.float32, device=pts.device)
        pt3d = unnormalize_pts(pts, un)
        rgb = preds["rgb_fine"].reshape(B, H // downsample, W // downsample, 3)
        return dict(im_pred=rgb.cpu().numpy(), pt3d=pt3d.cpu().numpy(),
                    pt_feat=preds["feat_fine"].reshape(B, n, -1).cpu().numpy())
