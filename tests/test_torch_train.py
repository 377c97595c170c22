"""Port parity, training slice: the train-render stage (forward and explicit
backward), the randomized resample, the NeRF losses and LR schedules, and
the trainer end to end, against the JAX package on the CPU at small widths.

The same seeded numpy inputs (and the same random draws) go into both
packages; weights cross through the weight bridge.  The Pallas kernels run
in interpret mode, as the JAX package's own tests run them.  Tolerances are
stated per test.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.config import dict2namespace
from nerfmatch_tpu.nerf.model import NerfConfig as JNerfConfig
from nerfmatch_tpu.nerf.model import init_nerf_params
from nerfmatch_tpu.nerf.embedding import pe_embedding as j_pe
from nerfmatch_tpu.ops.pallas.render_kernel import (FusedRenderSpec,
                                                    prepare_ray_inputs)
from nerfmatch_tpu.ops.pallas.render_train import (make_fused_train_render,
                                                   pack_mlp_weights_traced)

from nerfmatch_tpu_torch.nerf.model import NerfConfig, NerfMLP
from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
    StageSpec, render_train, render_train_plain, train_stage_forward)
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from test_torch_nerf import flat_params

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent

F, FD = 15, 4
HID, LAYERS, SKIPS = 64, 4, (2,)
S, N = 32, 8
DIRS = 6 * FD + 3


def t(x):
    return torch.tensor(np.asarray(x, np.float32))


def make_rays(n, seed, near=0.05, far=1.4):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), near), np.full((n, 1), far),
                           d, np.full((n, 1), 0.002)], -1).astype(np.float32)


@pytest.mark.parametrize("K,N,orient", [
    *[pytest.param(k, n, "backward", id=f"{k}-{n}")
      for k, n in [(64, 256), (32, 64), (128, 256)]],
    *[pytest.param(k, n, "forward", id=f"forward-{k}-{n}")
      for k, n in [(90, 256), (256, 256), (256, 128), (64, 32)]]])
def test_slot_images_follow_the_kernel_swizzle(K, N, orient):
    """Element (k, n) of a weight matrix lands where the kernels' ring slot
    reads it (csrc/render_train.cu: swz): slot k // 32, then the 64-column
    block, row k % 32, and the 16-byte chunk (n % 64) // 8 at position
    chunk ^ (row % 8).  The backward's images are of the (out x in) rows as
    given; the forward's (``_fwd_images``) of the (in x out) rows of the
    (out x in) weight, k = in padded to a multiple of 32 (the encoding's 90
    to 96) and n = out to 64 or more, with zeros."""
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        _fwd_images, slot_images)

    rng = np.random.default_rng(0)
    if orient == "backward":
        mat = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
        img = slot_images(mat).reshape(-1)
    else:
        w = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32))
        pk, pn = -(-K // 32) * 32, max(N, 64)
        img = _fwd_images(w, k=pk, n=pn)
        mat = torch.zeros(pk, pn)
        mat[:K, :N] = w.t()
        K, N = pk, pn
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    sl, r, nb, c, e = k // 32, k % 32, n // 64, (n % 64) // 8, n % 8
    off = sl * 32 * N + nb * 32 * 64 + r * 64 + (c ^ (r % 8)) * 8 + e
    assert img.dtype == torch.bfloat16 and img.numel() == K * N
    assert torch.equal(img[torch.from_numpy(off.reshape(-1))],
                       mat.to(torch.bfloat16).reshape(-1))


@pytest.mark.parametrize("hid,layers,skips,n,S", [
    (256, 8, (4,), 9216, 128), (64, 8, (4,), 64, 256), (64, 4, (2,), 8, 64)])
def test_stash_and_gradient_workspace_split_the_old_workspace(
        hid, layers, skips, n, S):
    """The training forward's stash and the backward's gradient workspace
    (csrc: carve_stash, carve_grad) are the old single backward workspace
    without its scratch rgb and weights; the stash bytes the forward writes
    are the old "stash forward" launch's traffic."""
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        DIRS_MAX, ENC_MAX, GRGB_WIDTH, REC_WIDTH, TILE_RAYS, backward_layout,
        workspace_bytes)

    cfg = NerfConfig(layer_num=layers, hid_dim=hid, xyz_dim=90, dirs_dim=27,
                     use_viewdirs=True, skips=skips)
    R, H, HV = n * S, hid, hid // 2
    a = lambda b: (b + 255) // 256 * 256
    lay = backward_layout(cfg, n, S)
    P = layers * H + H + HV + 4 + H + 4
    mat = layers * (ENC_MAX * H + H * H) + H * H + H * HV + DIRS_MAX * HV \
        + HV * GRGB_WIDTH
    old = [R * ENC_MAX * 2, *[R * H * 2] * layers, R * H * 2, R * HV * 2,
           R * REC_WIDTH * 4, n * DIRS_MAX * 2, *[R * H * 2] * layers,
           R * H * 2, R * HV * 2, R * GRGB_WIDTH * 2, n * HV * 2,
           (n // TILE_RAYS) * P * 4, n * 3 * 4, R * 4, lay.splits * mat * 4]
    stash, grad = workspace_bytes(cfg, n, S)
    assert stash + grad + a(n * 3 * 4) + a(R * 4) == sum(map(a, old))
    assert lay.stash == R * (2 * (ENC_MAX + layers * H + H + HV)
                             + 4 * REC_WIDTH) + n * DIRS_MAX * 2
    assert set(lay.traffic) == {"trunk backward", "weight-gradient GEMM",
                                "reductions"}
    if (hid, n, S) == (256, 9216, 128):
        assert lay.stash == 6_002_638_848   # 5,088 bytes a row + extras


@pytest.mark.parametrize("S", [32, 64, 128, 192, 256, 320])
def test_train_kernel_takes_64_128_or_256_samples(S, monkeypatch):
    """The train kernels' shape gate, which comes before any device work:
    S = 64 (one half of the backward's 128-row chunk, two rays a chunk) or
    whole chunks up to 256; other sample counts raise NotImplementedError.
    Past the gate, CPU tensors stop at the device check; without it they
    would reach the launch arguments."""
    from nerfmatch_tpu_torch.ops.kernels import render_train_kernel as rtk

    mlp = NerfMLP(NerfConfig(layer_num=2, hid_dim=64, xyz_dim=90, dirs_dim=27,
                             use_viewdirs=True))
    n = 4
    rays, z, noise = torch.zeros(n, 12), torch.zeros(n, S + 1), torch.zeros(n, S)
    args = (rtk.StageSpec(mlp, 15, 4), rays, z, noise, [])
    if S in (64, 128, 256):
        with pytest.raises(ValueError, match="CUDA tensors"):
            rtk._kernel_args(*args)
        monkeypatch.setattr(rtk, "require_cuda_tensors", lambda *a: None)
        assert rtk._kernel_args(*args)[6] == S
    else:
        with pytest.raises(NotImplementedError):
            rtk._kernel_args(*args)


@pytest.fixture(scope="module")
def stage():
    """JAX params of one small MLP (density bias +1, partly opaque) and the
    port's MLP with the same weights, plus seeded rays / jittered z / noise."""
    jcfg = JNerfConfig(layer_num=LAYERS, hid_dim=HID, xyz_dim=6 * F,
                       dirs_dim=DIRS, use_viewdirs=True, skips=SKIPS)
    params = init_nerf_params(jax.random.PRNGKey(0), jcfg)
    params["alpha_linear"]["bias"] = params["alpha_linear"]["bias"] + 1.0
    mlp = NerfMLP(NerfConfig(layer_num=LAYERS, hid_dim=HID, xyz_dim=6 * F,
                             dirs_dim=DIRS, use_viewdirs=True, skips=SKIPS))
    mlp.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    rng = np.random.default_rng(1)
    rays = make_rays(N, 2)
    tt = np.linspace(0, 1, S + 1)
    z = rays[:, 6:7] * (1 - tt) + rays[:, 7:8] * tt
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lo = np.concatenate([z[:, :1], mids], -1)
    hi = np.concatenate([mids, z[:, -1:]], -1)
    z = (lo + (hi - lo) * rng.uniform(size=z.shape)).astype(np.float32)
    noise = rng.normal(size=(N, S)).astype(np.float32)
    target = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return params, mlp, rays, z, noise, target


def jax_stage(params, rays, z, noise):
    spec = FusedRenderSpec(num_freqs=F, hid_dim=HID, layer_num=LAYERS,
                           skips=SKIPS, samples=S, ray_tile=N, feat_layer=0)
    fused = make_fused_train_render(spec, interpret=True)
    o8, d8 = prepare_ray_inputs(jnp.asarray(rays))
    extras = jnp.pad(j_pe(jnp.asarray(rays[:, 8:11]), FD),
                     ((0, 0), (0, 128 - DIRS)))

    def run(p):
        return fused(pack_mlp_weights_traced(p, spec), o8, d8,
                     jnp.asarray(z), extras, jnp.asarray(noise))
    return run


def stage_loss(rgb, w, target, np_mod):
    return np_mod.mean((rgb - target) ** 2) + 0.1 * np_mod.mean(w ** 2)


def test_train_stage_forward_matches_pallas(stage):
    """Plain train stage (bf16 operands as the kernel) vs the Pallas train
    kernel in interpret mode: rgb and weights at atol 2e-3 (sinf/expf vs the
    TPU's polynomial sin/exp, which move the bf16 encoding by a rounding
    here and there)."""
    params, mlp, rays, z, noise, _ = stage
    rgb_j, w_j = jax_stage(params, rays, z, noise)(params)
    spec = StageSpec(mlp, F, FD)
    with torch.no_grad():
        rgb, w = render_train(spec, t(rays), t(z), t(noise))
    np.testing.assert_allclose(rgb.numpy(), rgb_j, atol=2e-3)
    np.testing.assert_allclose(w.numpy(), w_j, atol=2e-3)
    assert float(w.sum(-1).max()) > 0.3          # the field is not empty


def _grads_by_jax_leaf(mlp):
    """Port grads keyed like flat JAX params ((in, out) layout)."""
    out = {}
    for name, p in mlp.named_parameters():
        g = p.grad.numpy()
        key = name.replace(".", "/")
        out[key] = g.T if g.ndim == 2 else g.reshape(-1)
    return out


def _compare(ours, ref, cos_min, ratio, label):
    checked = 0
    for k, a in ref.items():
        a = np.asarray(a).ravel()
        b = np.asarray(ours[k]).ravel()
        if np.linalg.norm(a) < 1e-7:
            continue
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
        r = np.linalg.norm(b) / (np.linalg.norm(a) + 1e-12)
        assert cos > cos_min and ratio[0] < r < ratio[1], (label, k, cos, r)
        checked += 1
    return checked


def test_train_stage_grads_match_pallas_vjp(stage):
    """Explicit plain backward vs JAX's custom VJP (interpret) through
    mse(rgb) + 0.1 mean(w^2): per leaf cosine > 0.999 and norm ratio within
    1 +- 1e-2 (same bf16 operand roundings; f32 sums in other orders);
    every leaf with a real gradient checked."""
    params, mlp, rays, z, noise, target = stage
    run = jax_stage(params, rays, z, noise)
    g_j = jax.grad(lambda p: stage_loss(*run(p), jnp.asarray(target), jnp))(
        params)
    mlp.zero_grad()
    rgb, w = render_train_plain(StageSpec(mlp, F, FD), t(rays), t(z), t(noise))
    stage_loss(rgb, w, t(target), torch).backward()
    ours = _grads_by_jax_leaf(mlp)
    ref = {k: v for k, v in flat_params(g_j).items()}
    assert _compare(ours, ref, 0.999, (0.99, 1.01), "pallas") >= 4 * LAYERS


def test_train_stage_grads_match_f32_autograd(stage):
    """The explicit bf16 backward vs autograd of the f32 plain stage: the
    looser semantic bound of the JAX package's own test (cosine > 0.98,
    norm ratio in 0.8-1.25)."""
    params, mlp, rays, z, noise, target = stage
    spec = StageSpec(mlp, F, FD)
    mlp.zero_grad()
    rgb, w = train_stage_forward(spec, t(rays), t(z), t(noise), bf16=False)
    stage_loss(rgb, w, t(target), torch).backward()
    ref = _grads_by_jax_leaf(mlp)
    mlp.zero_grad()
    rgb, w = render_train_plain(spec, t(rays), t(z), t(noise))
    stage_loss(rgb, w, t(target), torch).backward()
    ours = _grads_by_jax_leaf(mlp)
    assert _compare(ours, ref, 0.98, (0.8, 1.25), "f32") >= 4 * LAYERS


def test_randomized_resample_matches_pallas_lookup():
    """Resample with the same stratified u: the port (plain version of the
    kernel) vs JAX's prep + _resample_lookup (interpret) at atol 1e-5."""
    from nerfmatch_tpu.ops.pallas.resample_kernel import _resample_lookup
    from nerfmatch_tpu_torch.nerf.sampling import stratified_u
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import resample_z

    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(0.05, 1.4, (16, 65)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(16, 64)).astype(np.float32)
    w[3] = 0.0
    u = stratified_u(16, 65, u_rand=t(rng.uniform(size=(16, 65)))).numpy()
    # JAX prep (resample_z_pallas) with the drawn u in place of its own.
    wp = np.concatenate([w[:, :1], w, w[:, -1:]], -1)
    wm = np.maximum(wp[:, :-1], wp[:, 1:])
    wb = 0.5 * (wm[:, :-1] + wm[:, 1:]) + 0.01
    ws = wb.sum(-1, keepdims=True)
    pad = np.maximum(0.0, 1e-5 - ws)
    pdf = (wb + pad / wb.shape[-1]) / (ws + pad)
    cdf = np.minimum(1.0, np.cumsum(pdf[:, :-1], -1))
    cdf = np.concatenate([np.zeros((16, 1)), cdf, np.ones((16, 1))], -1)
    ref = _resample_lookup(jnp.asarray(z), jnp.asarray(cdf, jnp.float32),
                           jnp.asarray(u), interpret=True)
    np.testing.assert_allclose(resample_z(t(z), t(w), u=t(u)).numpy(), ref,
                               atol=1e-5)
    assert np.all(np.diff(u, axis=-1) > 0) and u.max() < 1.0


def test_stratified_draws_follow_jax_formulas():
    """jitter_fenceposts / stratified_u compute the JAX formulas
    (sampling.py:176-182, 208-216) from the same uniforms, atol 1e-6."""
    from nerfmatch_tpu_torch.nerf.sampling import (jitter_fenceposts,
                                                   stratified_u)
    rng = np.random.default_rng(6)
    z = np.sort(rng.uniform(0.1, 2.0, (4, 9)), -1).astype(np.float32)
    r = rng.uniform(size=(4, 9)).astype(np.float32)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lo = np.concatenate([z[:, :1], mids], -1)
    hi = np.concatenate([mids, z[:, -1:]], -1)
    np.testing.assert_allclose(jitter_fenceposts(t(z), t(r)).numpy(),
                               lo + (hi - lo) * r, atol=1e-6)
    s = 1.0 / 9
    eps = np.finfo(np.float32).eps
    ref = np.minimum(np.arange(9) * s + r * (s - eps), 1 - eps)
    np.testing.assert_allclose(stratified_u(4, 9, u_rand=t(r)).numpy(), ref,
                               atol=1e-6)


def test_nerf_metrics_and_schedules_match_jax():
    """compute_nerf_metrics (0.5-scaled MSE, PSNR, distortion through the
    O(S) form) at rtol 1e-5, and every LR schedule at 1e-9 relative."""
    from nerfmatch_tpu.utils import metrics as jm
    from nerfmatch_tpu.utils.optim import make_lr_schedule as j_sched
    from nerfmatch_tpu_torch.utils import metrics as tm
    from nerfmatch_tpu_torch.utils.optim import make_lr_schedule as t_sched

    rng = np.random.default_rng(7)
    preds = {"rgb_coarse": rng.uniform(size=(32, 3)),
             "rgb_fine": rng.uniform(size=(32, 3)),
             "s_fine": np.sort(rng.uniform(size=(32, 17)), -1),
             "weights_fine": rng.uniform(size=(32, 16)) / 8}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    gt = rng.uniform(size=(32, 3)).astype(np.float32)
    loss_cfg = dict2namespace({"ray_reg_weight": 0.01})
    ref = jm.compute_nerf_metrics({k: jnp.asarray(v) for k, v in preds.items()},
                                  jnp.asarray(gt), cnfg_loss=loss_cfg)
    ours = tm.compute_nerf_metrics({k: t(v) for k, v in preds.items()}, t(gt),
                                   cnfg_loss=loss_cfg)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5)
    np.testing.assert_allclose(
        float(tm.distortion_loss(t(preds["s_fine"]), t(preds["weights_fine"]))),
        float(jm.distortion_loss(jnp.asarray(preds["s_fine"]),
                                 jnp.asarray(preds["weights_fine"]))),
        rtol=1e-5)
    for sched in ({"lr_scheduler": "cosine"},
                  {"lr_scheduler": "steplr", "decay_per_step": 3,
                   "decay_gamma": 0.5},
                  {"lr_scheduler": "steplr", "decay_step": [2, 5],
                   "decay_gamma": 0.1},
                  {"lr_scheduler": "poly", "poly_exp": 0.9},
                  {"lr_scheduler": "chained"},
                  {"lr_scheduler": "cosine", "warmup_epochs": 2,
                   "warmup_multiplier": 2.0}):
        cfg = dict2namespace({"optimizer": "adam", "lr": 1.6e-3,
                              "max_epochs": 15, **sched})
        a, b = t_sched(cfg), j_sched(cfg)
        for e in range(16):
            assert abs(a(e) - b(e)) <= 1e-9 * abs(b(e)) + 1e-15, (sched, e)


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "rmsprop", "radam",
                                  "ranger"])
def test_optimizers_follow_optax(name):
    """Five updates of each optimizer on the same quadratic, with weight
    decay 0.01 (coupled L2 except adamw): the port's torch.optim vs the JAX
    package's optax chain at rtol 1e-4, atol 1e-5 (f32 roundings that the
    per-element normalization of the adaptive methods magnifies near 0).
    RAdam and ranger (rectification from step 6, the ranger sync at 6) at
    rtol 1e-3: optax forms rho_t = rho_inf - 2 t b2^t / (1 - b2^t) in f32,
    about 1999 - 1993, which cancels to ~1e-4 relative."""
    import optax
    from nerfmatch_tpu.utils.optim import init_optimizer as j_init
    from nerfmatch_tpu_torch.utils.optim import init_optimizer as t_init

    cfg = dict2namespace({"optimizer": name, "lr": 0.05,
                          "weight_decay": 0.01})
    rng = np.random.default_rng(8)
    x0 = rng.normal(size=(6,)).astype(np.float32)
    target = rng.normal(size=(6,)).astype(np.float32)
    jopt = j_init(cfg)
    jp = {"x": jnp.asarray(x0)}
    js = jopt.init(jp)
    tp = torch.nn.Parameter(t(x0))
    topt = t_init(cfg, [tp])
    for _ in range(7):
        g = jax.grad(lambda p: jnp.sum((p["x"] - target) ** 3 / 3
                                       + (p["x"] - target) ** 2))(jp)
        up, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, up)
        topt.zero_grad()
        d = tp - t(target)
        (d ** 3 / 3 + d ** 2).sum().backward()
        topt.step()
    rtol = 1e-3 if name in ("radam", "ranger") else 1e-4
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp["x"]),
                               rtol=rtol, atol=1e-5)


# ---------------------------------------------------------------------------
# Renderer, dataset, trainer and CLI
# ---------------------------------------------------------------------------

def nerf_train_config(scene, odir, hid=64, layers=4, skips=(2,), pts=128,
                      **render):
    mlp = {"method": "NeRF", "layer_num": layers, "hid_dim": hid,
           "output_dim": 4, "skips": list(skips), "num_pts": pts}
    return dict2namespace({
        "data": {"dataset": "NerfBaseDataset", "data_dir": str(scene["root"]),
                 "scene": "toy", "img_wh": [64, 64], "ray_type": "mip",
                 "max_frustum_depth": 1, "rescale_factor": 1.0,
                 "snorm_type": "fst"},
        "optim": {"optimizer": "adam", "lr": 2e-3, "weight_decay": 0.0,
                  "lr_scheduler": "cosine"},
        "coarse_nerf": dict(mlp), "fine_nerf": dict(mlp),
        "embedding": {"xyz_num_freqs": 15, "dirs_num_freqs": 4, "type": "mip"},
        "render": {"chunksize": 4096, "use_viewdirs": True, "use_disp": False,
                   "perturb": True, "white_bg": False, "noise_std": 0.0,
                   "trunk_int8": "none", **render},
        "loss": {"ray_reg_weight": 0.01},
        "exp": {"seed": 1, "odir": str(odir), "prefix": "t", "num_workers": 0,
                "max_epochs": 2, "check_epochs": 1, "batch_size": 256,
                "gpus": 1, "debug": True, "log_num_max": 1, "log_step": 5},
    })


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tests._synthetic import build_scene

    return build_scene(tmp_path_factory.mktemp("torch_train_scene"))


@pytest.mark.parametrize("max_sample_num", [None, 3])
def test_dataset_rays_and_batches_match_jax(scene, tmp_path, max_sample_num):
    """NerfBaseDataset: split indices (the seeded draw with replacement when
    max_sample_num caps the train frames), all train rays / rgbs, a val
    sample and the first ray_batches batch of the same default_rng(3):
    equal to 1e-6 (both are numpy)."""
    from nerfmatch_tpu.data.nerf_dataset import NerfBaseDataset as JDataset
    from nerfmatch_tpu_torch.data.loaders import init_data_loader

    cfg = nerf_train_config(scene, tmp_path)
    cfg.data.max_sample_num = max_sample_num
    ours = init_data_loader(cfg.data, split="train").dataset
    ref = JDataset(cfg.data, split="train")
    np.testing.assert_array_equal(ours.split_inds, ref.split_inds)
    for k in ("all_rays", "all_rgbs", "all_ts"):
        np.testing.assert_allclose(getattr(ours, k), getattr(ref, k), atol=1e-6)
    a = next(ours.ray_batches(128, np.random.default_rng(3)))
    b = next(ref.ray_batches(128, np.random.default_rng(3)))
    for k in b:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6)
    val_ours = next(iter(init_data_loader(cfg.data, split="val")))
    val_ref = JDataset(cfg.data, split="val")[0]
    np.testing.assert_allclose(val_ours["rays"][0], val_ref["rays"], atol=1e-6)


def test_render_rays_train_matches_xla_path(scene, tmp_path):
    """render_rays(train=True) vs the JAX XLA training render with the same
    draws (regenerated from the JAX keys), noise_std 1: rgb and s_fine by
    mean 1e-5 / p99 1e-4 (the fine resample is chaotic at edges)."""
    from nerfmatch_tpu.nerf.renderer import NerfRenderer as JRenderer
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer

    cfg = nerf_train_config(scene, tmp_path, pts=32, noise_std=1.0)
    jr = JRenderer(cfg)
    params = jr.init_params(jax.random.PRNGKey(2))
    tr = NerfRenderer(cfg)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    rays = make_rays(16, 9)
    key = jax.random.PRNGKey(4)
    ref = jr.render_rays(params, jnp.asarray(rays), key=key, train=True)
    draws, k = {}, key
    eps = np.finfo(np.float32).eps
    for stage in ("coarse", "fine"):
        k, k_samp, k_noise = jax.random.split(k, 3)
        if stage == "coarse":
            draws["t_rand"] = t(jax.random.uniform(k_samp, (16, 33)))
        else:
            s = 1.0 / 33
            u = jnp.arange(33) * s + jax.random.uniform(
                k_samp, (16, 33), minval=0.0, maxval=s - eps)
            draws["u"] = t(jnp.minimum(u, 1.0 - eps))
        draws[f"noise_{stage}"] = t(jax.random.normal(k_noise, (16, 32)))
    with torch.no_grad():
        ours = tr.render_rays(t(rays), train=True, draws=draws)
    for k_ in ("rgb_coarse", "depth_coarse"):
        np.testing.assert_allclose(ours[k_].numpy(), ref[k_], atol=1e-4)
    for k_ in ("rgb_fine", "s_fine", "weights_fine"):
        err = np.abs(ours[k_].numpy() - np.asarray(ref[k_]))
        assert err.mean() < 1e-5 and np.quantile(err, 0.99) < 1e-4, (k_, err.max())


def test_trainer_steps_match_jax(scene, tmp_path):
    """Three NerfTrainer steps (perturb off, noise 0: no draws) from the same
    exported weights: the JAX trainer on its fused Pallas path (interpret)
    vs the port's on the plain versions of the train kernels.  Loss per step
    at rtol 2e-3.  The parameter updates after three adam steps: per tensor
    the difference of the two updates within 10% of the JAX update's norm,
    and every element within 6 lr (adam's per-element normalization turns
    bf16-level gradient differences into whole-step differences where a
    gradient is ~0)."""
    from nerfmatch_tpu.parallel.mesh import make_mesh
    from nerfmatch_tpu.train.nerf_trainer import NerfTrainer as JTrainer
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    cfg = nerf_train_config(scene, tmp_path, perturb=False,
                            use_fused_train=True)
    jt = JTrainer(cfg, num_frames=1, mesh=make_mesh(data=1))
    jt.renderer.fused_interpret = True
    params, opt_state = jt.init_state(0)
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 3.0
    opt_state = jt.opt.init(params)
    step = jt.train_step_fn()
    tt = NerfTrainer(cfg, device="cpu")
    start = state_dict_from_jax(flat_params(params))
    tt.renderer.load_state_dict(start, strict=True)
    ds = init_data_loader(cfg.data, split="train").dataset
    batches = ds.ray_batches(16, np.random.default_rng(0))
    for i in range(3):
        b = next(batches)
        params, opt_state, jm = step(params, opt_state, jnp.asarray(b["rays"]),
                                     jnp.asarray(b["rgbs"]),
                                     jnp.asarray(b["ts"], jnp.int32),
                                     jax.random.PRNGKey(i))
        m = tt.train_step(t(b["rays"]), t(b["rgbs"]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-3)
    ref = state_dict_from_jax(flat_params(params))
    for k, v in tt.renderer.state_dict().items():
        d_ours, d_ref = v - start[k], ref[k] - start[k]
        rel = float((d_ours - d_ref).norm() / d_ref.norm())
        assert rel < 0.1 and float((d_ours - d_ref).abs().max()) <= 6 * 2e-3, \
            (k, rel)


def test_trainer_rejects_unported_configs(scene, tmp_path):
    """``exp.gpus`` caps the devices: 2 in a world of one process trains on
    it (``gpu_num`` 1), 1 in a world of 2 ranks raises (a launched world
    cannot shrink), and so does a matcher's global batch of 3 over 2 ranks;
    an out_scr NeRF (ported since) trains, on the plain route, as the JAX
    trainer leaves its fused path for it."""
    from nerfmatch_tpu_torch.parallel.distributed import check_world
    from nerfmatch_tpu_torch.train.matcher_trainer import check_matcher_config
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    cfg = nerf_train_config(scene, tmp_path)
    cfg.exp.gpus = 2
    NerfTrainer(cfg, device="cpu")
    assert cfg.gpu_num == 1
    cfg.exp.gpus = 1
    with pytest.raises(ValueError, match="below the 2 launched"):
        check_world(cfg, world=2)
    cfg.exp.gpus, cfg.exp.batch_size = 0, 3
    check_matcher_config(cfg, world=1)
    with pytest.raises(ValueError, match="does not divide over 2"):
        check_matcher_config(cfg, world=2)
    cfg = nerf_train_config(scene, tmp_path, use_fused_train=True)
    cfg.data.out_scr = True
    assert NerfTrainer(cfg, device="cpu").route == "plain"


def test_cli_train_writes_last_checkpoint_and_resumes(scene, tmp_path):
    """cli.train_nerf.main on the synthetic scene (debug: 10 steps a
    epoch, 2 epochs; the plain render_rays(train=True) path with a bf16
    MLP) writes last_2 and best checkpoints; a second run
    resumes at epoch 2 and leaves the weights as they were; the checkpoint
    loads strictly into a fresh serving renderer."""
    from nerfmatch_tpu.config import save_config
    from nerfmatch_tpu_torch.cli.train_nerf import main
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.nerf_trainer import init_config_odir

    cfg = nerf_train_config(scene, tmp_path, hid=64, layers=3, skips=(1,),
                            pts=16, noise_std=1.0, compute_dtype="bfloat16")
    path = tmp_path / "cfg.yaml"
    save_config(path, cfg)
    out_cfg, r1 = main(["--config", str(path), "--device", "cpu"])
    run_dir = init_config_odir(out_cfg)
    last = latest_checkpoint(run_dir / "checkpoints", name="last")
    assert last is not None and last.name == "last_2"
    assert latest_checkpoint(run_dir / "checkpoints", name="best") is not None
    w1 = r1.nerf_fine.pts_linears[0].weight.detach().clone()
    assert torch.isfinite(w1).all()
    _, r2 = main(["--config", str(path), "--device", "cpu"])
    assert torch.equal(r2.nerf_fine.pts_linears[0].weight, w1)
    serving = NerfRenderer(out_cfg, stop_layer=1)
    serving.load_state_dict(torch.load(last / "model.pt"), strict=True)
    metrics = (run_dir / "metrics.jsonl").read_text().splitlines()
    assert any("val/rgb_fine_psnr" in line for line in metrics)


def test_training_modules_import_without_jax():
    """A fresh interpreter imports every training module of the port and
    its parallel package, takes one train_render step and a render sharded
    over two CPU devices without importing jax or the JAX package."""
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
import nerfmatch_tpu_torch.cli.train_nerf, nerfmatch_tpu_torch.data.loaders
import nerfmatch_tpu_torch.train.nerf_trainer
import nerfmatch_tpu_torch.cli.train_nerfmatch, nerfmatch_tpu_torch.cli.eval_nerf
import nerfmatch_tpu_torch.parallel.point_sharding
import nerfmatch_tpu_torch.parallel.pair_sharding
from nerfmatch_tpu_torch.parallel.distributed import process_info
from nerfmatch_tpu_torch.parallel.render_sharding import make_sharded_render
from nerfmatch_tpu_torch.parallel.mesh import make_mesh
from nerfmatch_tpu_torch.config import dict2namespace
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
mlp = dict(layer_num=2, hid_dim=64, skips=[0], num_pts=16, output_dim=4)
cfg = dict2namespace(dict(render=dict(use_viewdirs=True, white_bg=False),
    embedding=dict(xyz_num_freqs=15, dirs_num_freqs=4, type='mip'),
    coarse_nerf=dict(mlp), fine_nerf=dict(mlp)))
r = NerfRenderer(cfg).init_params(torch.Generator().manual_seed(0))
rays = torch.cat([torch.zeros(4, 3), torch.tensor([[0., 0., 1.]]).repeat(4, 1),
                  torch.tensor([[0.1, 1.0]]).repeat(4, 1),
                  torch.tensor([[0., 0., 1.]]).repeat(4, 1),
                  torch.full((4, 1), 1e-3)], -1)
out = r.train_render(rays, torch.Generator().manual_seed(0))
out['rgb_fine'].sum().backward()
assert r.nerf_fine.pts_linears[0].weight.grad is not None
assert process_info() == (0, 1)
mlp['num_pts'] = 32
r = NerfRenderer(dict2namespace(dict(render=dict(use_viewdirs=True,
    white_bg=False), embedding=dict(xyz_num_freqs=15, dirs_num_freqs=4,
    type='mip'), coarse_nerf=dict(mlp), fine_nerf=dict(mlp))), stop_layer=1)
with torch.no_grad():
    sharded = make_sharded_render(make_mesh(devices=['cpu', 'cpu']),
                                  r.init_params(torch.Generator()))(rays)
assert torch.isfinite(sharded['feat_fine']).all()
assert not any(m.split('.')[0] in ('jax', 'nerfmatch_tpu') for m in sys.modules)
print('OK')
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
