"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (each prints its results; any failure exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit, the
   TF32 switches (both off: dual-softmax and fine matching stay f32);
2. build: the hand-written CUDA kernels from ``nerfmatch_tpu_torch/csrc``;
3. kernel vs plain PyTorch version at the main path's shapes: the render
   stage (coarse and fine) on 9216 rays of the room fixture at eps 0 and
   1e-4, the resample on the coarse weights, and attention at B=1, H=8,
   D=32, L=S=3600 in f32 and bf16-operand modes;
3b. the same for training: the train-render forward and backward kernels
   on 9216 rays at full width (the room's fine MLP, jittered z, density
   noise of std 1, loss rgb MSE + 0.01 distortion), rgb / weights and every
   gradient leaf against the plain version with its explicit backward;
3c. the same for matcher training: the fused StarReLU + 7x7 depthwise conv
   (forward, dgrad, wgrad) at the c2f trunk's stage-0 and stage-1 shapes
   (2, 240, 240, 256) and (2, 60, 60, 512), and the attention backward at
   B=2, H=8, D=32, L=S=3600 in f32 and bf16-operand modes; each backward
   rerun must be bit-identical;
4. serving: the room NeRF (``pretrained/synthetic_room_nerf.npz``) and the
   production c2f matcher (random weights from a seed) localize three query
   photos (the port's own 480x480 renders on the room's camera circle)
   against scene points rendered at nearby database poses, through
   ``NeRFMatchEvaluator.eval_batch(iters=2, mutual=True)`` (the ConvFormer
   token mixers through the fused StarReLU + depthwise-conv kernel), plus one
   ``eval_bs=2`` request; the launch counters must show every kernel ran;
   one request's matches are checked against the plain path on the CPU;
5. training: a 24-frame 480x480 scene rendered from the room NeRF is
   written in the dataset's layout; ``cli.train_nerf --debug`` trains on it
   with ``configs/nerf/nerf_7scenes_mip_sfm.yaml`` (only the data paths and
   the output dir changed) and resumes; ``NerfTrainer`` then takes 50 steps
   of 9216 rays from a fresh initialization (loss must fall, PSNR rise);
   the launch counters must show the train kernels and the resample ran;
   the last checkpoint loads into a serving renderer that renders one ds-8
   scene-point grid through the eval kernels;
6. matcher training: a 24-frame room scene, its scene points cached through
   ``NerfEvaluator.cache_scene_pts`` (3600 points x 256-d per frame) and a
   pairs file; ``cli.train_nerfmatch --stage c2f --debug`` trains on it with
   ``configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml`` at full width (only
   the data paths, the output dir and ``exp.max_epochs: 2`` changed; no
   ImageNet weights in the repo, so the trunk trains from scratch) and
   resumes; one epoch of 20 CLI steps each with ``exp.num_workers`` 0 and 1
   times the loader's prefetch; 5 ``CoarseTrainStep`` steps on the coarse
   config; the c2f model then takes 100 steps of the coarse (unclamped)
   loss, after which the c2f's clamped coarse loss must send gradient to the
   trunk and the attention layers, then 30 timed ``C2FTrainStep`` steps at
   batch 2 (the loss on fixed match lists and the per-step coarse loss must
   fall), 3 profiled; the launch counters must show the attention,
   attention-backward and the three StarReLU + depthwise-conv kernels ran;
   the last CLI checkpoint loads strictly into ``NeRFMatchEvaluator`` and
   localizes one request.

The last two lines are the kernel summary and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

KERNEL_SOURCES = {
    "render_coarse": ("nerfmatch_tpu_torch/csrc/render.cu",
                      "nerfmatch_tpu/ops/pallas/render_kernel.py:1032"),
    "render_fine": ("nerfmatch_tpu_torch/csrc/render.cu",
                    "nerfmatch_tpu/ops/pallas/render_kernel.py:1032"),
    "resample": ("nerfmatch_tpu_torch/csrc/resample.cu",
                 "nerfmatch_tpu/ops/pallas/resample_kernel.py:82"),
    "attention": ("nerfmatch_tpu_torch/csrc/attention.cu",
                  "nerfmatch_tpu/ops/pallas/attention_kernel.py:99"),
    "render_train_fwd": ("nerfmatch_tpu_torch/csrc/render_train.cu",
                         "nerfmatch_tpu/ops/pallas/render_train.py:420"),
    "render_train_bwd": ("nerfmatch_tpu_torch/csrc/render_train.cu",
                         "nerfmatch_tpu/ops/pallas/render_train.py:455"),
    "attention_bwd": ("nerfmatch_tpu_torch/csrc/attention.cu",
                      "nerfmatch_tpu/ops/pallas/attention_kernel.py:184"),
    "dw_star_fwd": ("nerfmatch_tpu_torch/csrc/sepconv.cu",
                    "nerfmatch_tpu/ops/pallas/sepconv_kernel.py:133"),
    "dw_star_dgrad": ("nerfmatch_tpu_torch/csrc/sepconv.cu",
                      "nerfmatch_tpu/ops/pallas/sepconv_kernel.py:198"),
    "dw_star_wgrad": ("nerfmatch_tpu_torch/csrc/sepconv.cu",
                      "nerfmatch_tpu/ops/pallas/sepconv_kernel.py:268"),
}
SERVING_KERNELS = ("render_coarse", "render_fine", "resample", "attention",
                   "dw_star_fwd")
MATCH_KERNELS = ("attention", "attention_bwd", "dw_star_fwd", "dw_star_dgrad",
                 "dw_star_wgrad")
TRAIN_KERNELS = ("render_train_fwd", "render_train_bwd", "resample")
CAM_R, NEAR, FAR = 0.8, 0.05, 2.1        # scripts/train_bench_scene.py
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10):
    """Mean device time of ``fn()`` in ms (CUDA events, after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def room_c2w(ang):
    """c2w (OpenCV axes) of the room's camera circle at angle ``ang``, looking
    at the origin (the geometry of scripts/train_bench_scene.py)."""
    eye = np.array([CAM_R * np.cos(ang), 0.25 * np.sin(3 * ang),
                    CAM_R * np.sin(ang)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
    c2w[:3, 3] = eye
    return c2w


def camera_rays(c2w, size, dev):
    """(size^2, 12) rays of a size x size pinhole camera (the room's 64 px /
    focal 80 field of view) with the room's near/far planes."""
    from nerfmatch_tpu_torch.nerf.rays import (get_ray_dirs, get_rays_c2w,
                                               prepare_rays_data)

    K = camera_K(size)
    dirs = get_ray_dirs(size, size, torch.as_tensor(K, device=dev))
    o, d, v = get_rays_c2w(dirs, torch.as_tensor(c2w, dtype=torch.float32,
                                                 device=dev))
    near = torch.full_like(d[..., :1], NEAR)
    far = torch.full_like(d[..., :1], FAR)
    rays = prepare_rays_data(o, v, v, near, far)
    return rays.reshape(-1, 12).contiguous()


def camera_K(size):
    f = 80.0 * size / 64.0
    return np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)


def max_err(a, b, scaled=False):
    """Largest absolute error over the outputs; ``scaled``: relative to each
    output's largest value where that exceeds 1 (features, depths)."""
    return max(float((a[k] - b[k]).abs().max())
               / (max(1.0, float(b[k].abs().max())) if scaled else 1.0)
               for k in b)


def phase_environment():
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi}")
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False (dual-softmax, "
        "fine matching and the backbone features they see stay f32)")
    return smi


def phase_build():
    from nerfmatch_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib}")
    for line in kernels.BUILD_INFO.get("log", "").splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas " + line.strip())


def phase_kernels(renderer, dev):
    """Kernel vs plain version at the main path's shapes -> summary rows."""
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_plain, fused_attention)
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import (
        pack_mlp, render_stage, render_stage_plain)
    from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (
        resample_z, resample_z_plain)

    rows = {}
    rays = camera_rays(room_c2w(0.4), 96, dev)          # 9216 rays, unit dirs
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4)
    stages = {"render_coarse": (renderer.nerf_coarse, False),
              "render_fine": (renderer.nerf_fine, True)}
    z_in = {"render_coarse": z}
    # The plain version rounds the same MLP operands to bf16: the kernel
    # differs from it by f32 accumulation order and the bf16 rounding ties
    # this breaks apart.  The f32-MLP plain version is reported beside it.
    tol = 5e-3
    for eps in (0.0, 1e-4):
        for name, (mlp, fine) in stages.items():
            if name == "render_fine":
                coarse = render_stage_plain(renderer.nerf_coarse, rays, z,
                                            fine=False, early_term_eps=eps, **kw)
                z_in[name] = resample_z_plain(z, coarse["weights"]).contiguous()
            packed = pack_mlp(mlp)
            args = dict(fine=fine, early_term_eps=eps, **kw)
            run_k = lambda: render_stage(mlp, rays, z_in[name], packed=packed,
                                         **args)
            run_p = lambda: render_stage_plain(mlp, rays, z_in[name], **args)
            a, b = run_k(), run_p()
            f32 = render_stage_plain(mlp, rays, z_in[name], trunk_bf16=False,
                                     **args)
            torch.cuda.synchronize()
            err, scaled = max_err(a, b), max_err(a, b, scaled=True)
            err32 = {k: float(f"{float((a[k] - f32[k]).abs().max()):.3e}")
                     for k in a}
            ms, plain_ms = cuda_ms(run_k, 3), cuda_ms(run_p, 3)
            skipped = float((a["weights"] == 0).float().mean())
            log(f"kernel {name} eps={eps:g}: max_abs_err={err:.3e} scaled "
                f"{scaled:.3e} (tol {tol:g}, vs plain with bf16 MLP operands; "
                f"max abs vs f32 MLP {err32}) ms={ms:.3f} "
                f"plain_ms={plain_ms:.3f} zero-weight share={skipped:.3f}")
            assert scaled < tol and all(torch.isfinite(v).all()
                                        for v in a.values())
            if eps > 0:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    w = render_stage_plain(renderer.nerf_coarse, rays, z, fine=False,
                           early_term_eps=1e-4, **kw)["weights"].contiguous()
    a, b = resample_z(z, w), resample_z_plain(z, w)
    err = float((a - b).abs().max())
    ms = cuda_ms(lambda: resample_z(z, w))
    plain_ms = cuda_ms(lambda: resample_z_plain(z, w), 3)
    log(f"kernel resample: max_abs_err={err:.3e} (tol 1e-4) ms={ms:.3f} "
        f"plain_ms={plain_ms:.3f}")
    assert err < 1e-4
    rows["resample"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(1, 3600, 8, 32, device=dev, generator=g) / np.sqrt(32)
    k = torch.randn(1, 3600, 8, 32, device=dev, generator=g)
    v = torch.randn(1, 3600, 8, 32, device=dev, generator=g)
    # bf16 mode: both sides round q, k, v and the probabilities to bf16, and
    # their exps and summation orders break a few rounding ties apart.
    tols = {False: (1e-4, 1e-4), True: (1e-3, 1e-5)}   # (max, mean)
    for bf16 in (False, True):
        a = fused_attention(q, k, v, bf16)
        b = attention_plain(q, k, v, bf16)
        err, mean_err = float((a - b).abs().max()), float((a - b).abs().mean())
        ms = cuda_ms(lambda: fused_attention(q, k, v, bf16))
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, bf16))
        log(f"kernel attention bf16={bf16}: max_abs_err={err:.3e} mean "
            f"{mean_err:.3e} (tol max {tols[bf16][0]:g}, mean "
            f"{tols[bf16][1]:g}) ms={ms:.3f} plain_ms={plain_ms:.3f}")
        assert err < tols[bf16][0] and mean_err < tols[bf16][1]
        if bf16:   # the serving default (attn_bf16=True)
            rows["attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rows


def make_request(renderer, ang, dev, size=480):
    """A query photo (the port's render at ``ang``) and scene points rendered
    at a database pose 0.12 rad further along the circle."""
    c2w = room_c2w(ang)
    rgb = renderer.fused_predict(camera_rays(c2w, size, dev))["rgb_fine"]
    assert torch.isfinite(rgb).all(), "query render is not finite"
    img = rgb.reshape(size, size, 3).clamp(0, 1).cpu().numpy()
    ys, xs = np.meshgrid(np.arange(size // 8), np.arange(size // 8),
                         indexing="ij")
    m = (size // 8) ** 2
    return dict(image=((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32),
                im_mask=np.ones(m, np.float32),
                pt2d=(np.stack([xs, ys], -1).reshape(-1, 2) * 8 + 4).astype(
                    np.float32),
                K=camera_K(size), c2w=c2w.astype(np.float32),
                unnorm_scene=np.eye(4, dtype=np.float32),
                db_c2w=room_c2w(ang + 0.12))


def scene_points(renderer, reqs, size=480):
    outs = renderer.render_novel_views(
        (size, size), [r["K"] for r in reqs], [r["db_c2w"] for r in reqs],
        [r["unnorm_scene"] for r in reqs], downsample=8)
    batch = {k: np.stack([r[k] for r in reqs]) for k in
             ("image", "im_mask", "pt2d", "K", "c2w", "unnorm_scene")}
    batch.update(pt3d=outs["pt3d"], pt_feat=outs["pt_feat"],
                 pt_mask=np.ones(outs["pt3d"].shape[:2], np.float32))
    for k in ("pt3d", "pt_feat"):
        assert np.isfinite(batch[k]).all(), k
    return batch


def phase_serving(renderer, evaluator, dev, size=480):
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts

    angles = [0.3 + 2.1 * i for i in range(3)]
    reqs = [make_request(renderer, a, dev, size) for a in angles]
    kw = dict(iters=2, mutual=True, solver="colmap", rthres=10.0)
    # Warm-up request (cuDNN autotuning, allocator), not counted.
    evaluator.eval_batch(scene_points(renderer, reqs[:1], size), renderer=renderer,
                         **kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    results = []
    for i, group in enumerate([[0], [1], [2], [0, 1]]):
        t0 = time.perf_counter()
        batch = scene_points(renderer, [reqs[j] for j in group], size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = evaluator.eval_batch(batch, renderer=renderer, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for c2w, r_err, t_err in zip(res["c2w_est"], res["R_err"],
                                     res["t_err"]):
            # A query whose PnP failed reports inf errors and no pose;
            # every solved one must be finite.
            assert (c2w is None and r_err == t_err == float("inf")) or (
                np.isfinite(c2w).all() and np.isfinite([r_err, t_err]).all())
        rerendered = sum(c is not None for c in res["c2w_est"])
        row = dict(request=i, queries=group, scene_points_ms=(t1 - t0) * 1e3,
                   localize_ms=(t2 - t1) * 1e3,
                   num_matches=res["num_matches"], R_err_deg=res["R_err"],
                   t_err=res["t_err"], pnp_ok_final=rerendered)
        log("request " + json.dumps(row))
        results.append((batch, res))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"launches during serving: {json.dumps(launches)}")
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    return launches, results


def phase_check(evaluator, batch):
    """One request's first-iteration matches: GPU (f32 attention operands)
    vs the plain path on the CPU, same weights and inputs."""
    from nerfmatch_tpu_torch.models.attention import set_attention_bf16

    model = evaluator.model
    args = [batch[k][:1] for k in ("image", "pt_feat", "pt3d", "im_mask",
                                   "pt_mask")]
    set_attention_bf16(model, False)
    gpu = evaluator._match(*args, True, 0.0)
    set_attention_bf16(model, True)
    bf = evaluator._match(*args, True, 0.0)
    model.cpu()
    evaluator.device = torch.device("cpu")
    cpu = evaluator._match(*args, True, 0.0)
    for out in (gpu, bf, cpu):
        for k in ("mconf", "expec_f"):
            assert np.isfinite(out[k]).all(), k
    pairs = lambda o: set(zip(o["lists"]["i_ids"][0][o["lists"]["valid"][0]],
                              o["lists"]["j_ids"][0][o["lists"]["valid"][0]]))
    pg, pc, pb = pairs(gpu), pairs(cpu), pairs(bf)
    agree = len(pg & pc) / max(len(pg | pc), 1)
    common = np.asarray(gpu["valid"][0] & cpu["valid"][0]
                        & (gpu["j_ids"][0] == cpu["j_ids"][0]))
    M = gpu["j_ids"].shape[1]
    ef = np.abs(gpu["expec_f"].reshape(-1, M, 3)[0][common]
                - cpu["expec_f"].reshape(-1, M, 3)[0][common])
    ef_max = float(ef.max()) if ef.size else 0.0
    log(f"check: gpu-f32 vs cpu-plain matches {len(pg)} vs {len(pc)}, "
        f"jaccard {agree:.4f} (min 0.98); expec_f max_abs_err {ef_max:.2e} "
        f"(tol 1e-3); bf16-operand vs f32 jaccard "
        f"{len(pb & pg) / max(len(pb | pg), 1):.4f} (reported)")
    assert agree >= 0.98 and ef_max < 1e-3


def phase_train_kernels(renderer, dev):
    """Train-render kernels (forward, backward) vs the plain version at the
    training path's shapes -> summary rows."""
    from nerfmatch_tpu_torch.nerf.compositing import t_to_s
    from nerfmatch_tpu_torch.nerf.sampling import (jitter_fenceposts,
                                                   jitter_uniforms)
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        StageSpec, kernel_backward, kernel_forward, pack_train,
        train_stage_backward, train_stage_forward)
    from nerfmatch_tpu_torch.utils.metrics import distortion_loss

    g = torch.Generator(dev).manual_seed(1)
    rays = camera_rays(room_c2w(0.4), 96, dev)           # 9216 rays
    n, S = rays.shape[0], 128
    t = torch.linspace(0.0, 1.0, S + 1, device=dev)
    z = jitter_fenceposts(rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t,
                          jitter_uniforms(n, S + 1, g, dev)).contiguous()
    noise = torch.randn(n, S, device=dev, generator=g)   # noise_std 1.0
    target = torch.rand(n, 3, device=dev, generator=g)
    spec = StageSpec(renderer.nerf_fine, 15, 4)
    packed = pack_train(spec.mlp)
    with torch.no_grad():
        rgb, w = kernel_forward(spec, rays, z, noise, packed)
        rgb_p, w_p = train_stage_forward(spec, rays, z, noise)
    rgb_r, w_r = rgb.requires_grad_(), w.requires_grad_()
    loss = ((rgb_r - target) ** 2).mean() + 0.01 * distortion_loss(
        t_to_s(z, z.min(), z.max()), w_r)
    g_rgb, g_w = torch.autograd.grad(loss, (rgb_r, w_r))
    ga = kernel_backward(spec, rays, z, noise, g_rgb, g_w, packed)
    gb = train_stage_backward(spec, rays, z, noise, g_rgb, g_w)
    torch.cuda.synchronize()
    # Same bf16 operand roundings on both sides: f32 sums in other orders
    # (and the gradients' bf16 rounding ties they break apart) remain.
    fwd_err = max(float((rgb - rgb_p).abs().max()),
                  float((w - w_p).abs().max()))
    leaf = {}
    for k, ref in gb.items():
        got = ga[k]
        assert torch.isfinite(got).all(), k
        scale = float(ref.abs().max())
        cos = float((got * ref).sum()) / max(float(got.norm() * ref.norm()),
                                             1e-30)
        leaf[k] = (float((got - ref).abs().max()) / max(scale, 1e-30), cos)
    bwd_err = max(e for e, _ in leaf.values())
    worst = max(leaf, key=lambda k: leaf[k][0])
    min_cos = min(c for _, c in leaf.values())
    with torch.no_grad():
        ms_f = cuda_ms(lambda: kernel_forward(spec, rays, z, noise, packed), 5)
        plain_f = cuda_ms(lambda: train_stage_forward(spec, rays, z, noise), 2)
        ms_b = cuda_ms(lambda: kernel_backward(spec, rays, z, noise, g_rgb,
                                               g_w, packed), 3)
        plain_b = cuda_ms(lambda: train_stage_backward(spec, rays, z, noise,
                                                       g_rgb, g_w), 1)
    log(f"kernel render_train_fwd: max_abs_err={fwd_err:.3e} (rgb and "
        f"weights, tol 5e-3) ms={ms_f:.3f} plain_ms={plain_f:.3f} "
        f"acc max={float(w.sum(-1).max()):.3f}")
    log(f"kernel render_train_bwd: max scaled err={bwd_err:.3e} ({worst}; "
        f"tol 3e-2 of each leaf's largest gradient), min cosine "
        f"{min_cos:.6f} (tol 0.999) ms={ms_b:.3f} plain_ms={plain_b:.3f} "
        f"(plain chunked over 1024 rays)")
    log("  per-leaf scaled err: " + json.dumps(
        {k: float(f"{e:.2e}") for k, (e, _) in leaf.items()}))
    assert fwd_err < 5e-3 and bwd_err < 3e-2 and min_cos > 0.999
    return {"render_train_fwd": dict(max_abs_err=fwd_err, ms=ms_f,
                                     plain_ms=plain_f),
            "render_train_bwd": dict(max_abs_err=bwd_err, ms=ms_b,
                                     plain_ms=plain_b)}


def scaled_err(a, b):
    """Largest absolute error over the largest absolute reference value."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_matcher_kernels(dev):
    """The fused StarReLU + depthwise conv (kernels 7, 8, 9) and the
    attention backward (kernel 4) vs their plain versions at matcher
    training's shapes -> summary rows."""
    from torch.nn import functional as F

    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        attention_bwd, attention_bwd_plain)
    from nerfmatch_tpu_torch.ops.kernels.sepconv_kernel import (
        dw_star_dgrad, dw_star_dgrad_plain, dw_star_fwd, dw_star_plain,
        dw_star_wgrad, dw_star_wgrad_plain)

    rows = {}
    g = torch.Generator(dev).manual_seed(2)
    # f32 on both sides (TF32 is off): the kernels sum the 49 taps, and the
    # per-block partials of ds, db and dw, in other orders than cuDNN and
    # torch.sum do.
    for stage, shape in (("stage 0", (2, 240, 240, 256)),
                         ("stage 1", (2, 60, 60, 512))):
        C = shape[-1]
        x = torch.randn(shape, device=dev, generator=g)
        w = torch.randn(7, 7, C, device=dev, generator=g) * 0.1
        cb = torch.randn(C, device=dev, generator=g)
        s = torch.tensor(0.8944, device=dev)
        b = torch.tensor(-0.4472, device=dev)
        up = torch.randn(shape, device=dev, generator=g)
        y, y_p = dw_star_fwd(x, w, cb, s, b), dw_star_plain(x, w, cb, s, b)
        dx, ds, db = dw_star_dgrad(x, w, s, up)
        dx_p, ds_p, db_p = dw_star_dgrad_plain(x, w, s, up)
        dw, dw_p = dw_star_wgrad(x, s, b, up), dw_star_wgrad_plain(x, s, b, up)
        rerun = dw_star_dgrad(x, w, s, up)
        same = (torch.equal(rerun[0], dx) and torch.equal(rerun[1], ds)
                and torch.equal(rerun[2], db)
                and torch.equal(dw_star_wgrad(x, s, b, up), dw))
        wf = torch.flip(w, (0, 1)).permute(2, 0, 1).unsqueeze(1)
        dact = F.conv2d(up.permute(0, 3, 1, 2), wf, padding=3,
                        groups=C).permute(0, 2, 3, 1)
        r2 = torch.relu(x) ** 2
        torch.cuda.synchronize()
        errs = {"y": scaled_err(y, y_p), "dx": scaled_err(dx, dx_p),
                "dw": scaled_err(dw, dw_p),
                "ds": abs(float(ds - ds_p)) / float((dact * r2).abs().sum()),
                "db": abs(float(db - db_p)) / float(dact.abs().sum())}
        times = {
            "dw_star_fwd": (cuda_ms(lambda: dw_star_fwd(x, w, cb, s, b)),
                            cuda_ms(lambda: dw_star_plain(x, w, cb, s, b))),
            "dw_star_dgrad": (cuda_ms(lambda: dw_star_dgrad(x, w, s, up)),
                              cuda_ms(lambda: dw_star_dgrad_plain(x, w, s, up))),
            "dw_star_wgrad": (cuda_ms(lambda: dw_star_wgrad(x, s, b, up)),
                              cuda_ms(lambda: dw_star_wgrad_plain(x, s, b, up),
                                      3))}
        abs_err = {"dw_star_fwd": float((y - y_p).abs().max()),
                   "dw_star_dgrad": float((dx - dx_p).abs().max()),
                   "dw_star_wgrad": float((dw - dw_p).abs().max())}
        log(f"kernel dw_star {stage} {tuple(shape)}: scaled err "
            + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
            + " (tol 1e-4 of the largest value for y, dx, dw; 1e-5 of the "
            "sum of |terms| for ds, db); rerun bit-identical "
            f"{same}; ms / plain_ms " + json.dumps(
                {k: [round(a, 3), round(p, 3)] for k, (a, p) in times.items()}))
        assert max(errs["y"], errs["dx"], errs["dw"]) < 1e-4
        assert max(errs["ds"], errs["db"]) < 1e-5 and same
        assert all(torch.isfinite(t).all() for t in (y, dx, dw, ds, db))
        if stage == "stage 0":
            rows.update({k: dict(max_abs_err=abs_err[k], ms=a, plain_ms=p)
                         for k, (a, p) in times.items()})
        del x, up, y, y_p, dx, dx_p, dact, r2, rerun

    q = torch.randn(2, 3600, 8, 32, device=dev, generator=g) / np.sqrt(32)
    k = torch.randn(2, 3600, 8, 32, device=dev, generator=g)
    v = torch.randn(2, 3600, 8, 32, device=dev, generator=g)
    up = torch.randn(2, 3600, 8, 32, device=dev, generator=g)
    # bf16 mode: both sides round q, k, v, g, z and dl to bf16; other
    # summation orders break a few of those rounding ties apart.
    tols = {False: (1e-4, 0.99999), True: (1e-2, 0.999)}  # (scaled, cosine)
    for bf16 in (False, True):
        got = attention_bwd(q, k, v, up, bf16)
        again = attention_bwd(q, k, v, up, bf16)
        ref = attention_bwd_plain(q, k, v, up, bf16)
        torch.cuda.synchronize()
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        err = max(scaled_err(a, r) for a, r in zip(got, ref))
        cos = min(float((a * r).sum()) / float(a.norm() * r.norm())
                  for a, r in zip(got, ref))
        abs_err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        ms = cuda_ms(lambda: attention_bwd(q, k, v, up, bf16))
        plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, up, bf16), 3)
        log(f"kernel attention_bwd bf16={bf16}: dq/dk/dv scaled err "
            f"{err:.3e} (tol {tols[bf16][0]:g}), min cosine {cos:.6f} (tol "
            f"{tols[bf16][1]}), max_abs_err {abs_err:.3e}, rerun "
            f"bit-identical {same} ms={ms:.3f} plain_ms={plain_ms:.3f}")
        assert err < tols[bf16][0] and cos > tols[bf16][1] and same
        if bf16:   # the training default (attn_bf16=True)
            rows["attention_bwd"] = dict(max_abs_err=abs_err, ms=ms,
                                         plain_ms=plain_ms)
    return rows


def write_room_scene(renderer, dev, root, n_frames=24, size=480):
    """The room NeRF's renders on its camera circle, in the dataset's layout:
    <root>/room/seq-01/frame-XXX.color.png + transforms_{train,test}.json."""
    from PIL import Image

    scene = root / "room"
    (scene / "seq-01").mkdir(parents=True)
    frames = []
    with torch.no_grad():
        for i in range(n_frames):
            c2w = room_c2w(2 * np.pi * i / n_frames)
            rgb = renderer.fused_predict(camera_rays(c2w, size, dev))["rgb_fine"]
            img = rgb.reshape(size, size, 3).clamp(0, 1).cpu().numpy()
            name = f"seq-01/frame-{i:03d}.color.png"
            Image.fromarray((img * 255).round().astype(np.uint8)).save(
                scene / name)
            frames.append(dict(file_path=name, intrinsics=camera_K(size).tolist(),
                               height=size, width=size,
                               transform_matrix=c2w.tolist()))
    for split in ("train", "test"):
        (scene / f"transforms_{split}.json").write_text(
            json.dumps({"frames": frames}))


def phase_training(renderer, dev, seed):
    """Train on the room scene through the CLI (debug, resume) and 50
    NerfTrainer steps; serve the checkpoint -> launch counts."""
    import tempfile

    from nerfmatch_tpu_torch.config import load_yaml_config, save_config
    from nerfmatch_tpu_torch.cli.train_nerf import main as train_cli
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.nerf_trainer import (NerfTrainer,
                                                        init_config_odir)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_room_scene(renderer, dev, root)
        log(f"training scene: 24 frames 480x480 written in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg_path = ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml"
        cfg, _ = load_yaml_config(cfg_path)
        cfg.data.data_dir = str(root)
        cfg.data.scene = "room"
        cfg.data.scene_anno_path = str(root / "#scene" / "transforms_#split.json")
        cfg.exp.odir = str(root / "out")
        save_config(root / "cfg.yaml", cfg)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out_cfg, r1 = train_cli(["--config", str(root / "cfg.yaml"), "--debug"])
        t1 = time.perf_counter()
        w1 = r1.nerf_fine.pts_linears[0].weight.detach().clone()
        _, r2 = train_cli(["--config", str(root / "cfg.yaml"), "--debug"])
        t2 = time.perf_counter()
        assert torch.equal(r2.nerf_fine.pts_linears[0].weight, w1), "resume"
        ckpt = latest_checkpoint(init_config_odir(out_cfg) / "checkpoints",
                                 name="last")
        assert ckpt is not None and ckpt.name == f"last_{cfg.exp.max_epochs}"
        log(f"cli --debug: {cfg.exp.max_epochs} epochs x 10 steps of "
            f"{cfg.exp.batch_size} rays + validation in {t1 - t0:.1f} s; "
            f"resumed at epoch {cfg.exp.max_epochs} in {t2 - t1:.1f} s "
            f"({ckpt.name})")

        trainer = NerfTrainer(cfg, device=dev, seed=seed)
        ds = init_data_loader(cfg.data, split="train").dataset
        batches = ds.ray_batches(cfg.exp.batch_size,
                                 np.random.default_rng(seed))
        gen = torch.Generator(dev).manual_seed(seed)
        dev_batch = lambda b: (torch.as_tensor(b["rays"], device=dev),
                               torch.as_tensor(b["rgbs"], device=dev))
        steps = [dev_batch(next(batches)) for _ in range(56)]
        hist = [trainer.train_step(*steps[i], gen) for i in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist += [trainer.train_step(*steps[i], gen) for i in range(2, 52)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 50 * 1e3
        launches = dict(LAUNCHES)
        log(f"launches during training: {json.dumps(launches)}")
        missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
        assert not missing, f"kernels never launched in training: {missing}"
        loss = [float(m["loss"]) for m in hist]
        psnr = [float(m["rgb_fine_psnr"]) for m in hist]
        assert all(np.isfinite(loss)), "non-finite loss"
        assert np.mean(loss[-5:]) < np.mean(loss[:5]), loss
        assert np.mean(psnr[-5:]) > np.mean(psnr[:5]), psnr

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(52, 56):
                trainer.train_step(*steps[i], gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # Kernel rows only: an op's device time already holds its kernels,
        # and a user annotation's range (the optimizer step) spans kernels.
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
        dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:8]
        log(f"training: {step_ms:.1f} ms/step, "
            f"{cfg.exp.batch_size / step_ms * 1e3:.0f} rays/s over 50 steps "
            f"of {cfg.exp.batch_size} rays; loss {loss[0]:.4f} -> "
            f"{np.mean(loss[-5:]):.4f}, train psnr {psnr[0]:.2f} -> "
            f"{np.mean(psnr[-5:]):.2f} dB; profiled 4 steps: wall "
            f"{wall:.1f} ms, device {dev_ms:.1f} ms, idle share "
            f"{max(0.0, 1 - dev_ms / wall):.2f}")
        log("  device time by kernel (ms, 4 steps): " + json.dumps(
            {e.key[:60]: round(e.self_device_time_total / 1e3, 2)
             for e in top}))

        serving = NerfRenderer(cfg, stop_layer=3)
        serving.load_state_dict(torch.load(ckpt / "model.pt"), strict=True)
        serving = serving.to(dev).eval()
        with torch.no_grad():
            out = serving.render_novel_view((480, 480), camera_K(480),
                                            room_c2w(0.5), ds.unnorm_scene)
        for k, v in out.items():
            assert np.isfinite(v).all(), k
        log(f"served {ckpt.name}: ds-8 grid pt3d {out['pt3d'].shape} "
            f"pt_feat {out['pt_feat'].shape}")
    return launches


def write_match_scene(renderer, nerf_cfg, dev, root, n_frames=24, size=480):
    """Matcher training data from the room NeRF: the room scene
    (``write_room_scene``), its scene points cached per frame through
    ``NerfEvaluator.cache_scene_pts`` on the ds-8 grid, and a pairs file
    (each frame with its +-1 and +-2 neighbours) -> (cache dir, pairs file).

    The dataset's fst normalization is set to the identity (its
    ``rescale_factor``) so the NeRF renders the scene points in the frame it
    was trained in, the frame of the images and poses."""
    import copy

    from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator
    from nerfmatch_tpu_torch.nerf.scene import compute_scene_normalization_fst

    write_room_scene(renderer, dev, root, n_frames, size)
    anno = root / "room" / "transforms_train.json"
    scale = float(compute_scene_normalization_fst(anno, 1.0, 1.0)[0, 0])
    cfg = copy.deepcopy(nerf_cfg)
    cfg.data.data_dir = str(root)
    cfg.data.scene = "room"
    cfg.data.scene_anno_path = str(root / "#scene" / "transforms_#split.json")
    cfg.data.img_wh = [size, size]
    cfg.data.max_frustum_depth = 1.0
    cfg.data.rescale_factor = scale
    cfg.data.downsample = cfg.downsample = 8
    cfg.split = "test"                                    # every frame
    cache = NerfEvaluator(cfg, renderer).cache_scene_pts(
        cache_dir=root / "scene_cache")
    frames = sorted(json.loads(anno.read_text())["frames"],
                    key=lambda f: f["file_path"])
    n = len(frames)
    pairs = root / "pairs.txt"
    pairs.write_text("".join(
        f"{frames[i]['file_path']} {frames[(i + d) % n]['file_path']}\n"
        for i in range(n) for d in (-2, -1, 1, 2)))
    return cache, pairs


def phase_matcher_training(renderer, nerf_cfg, dev, seed, size=480,
                           n_frames=24, timed_steps=30, warm_steps=100):
    """Train the c2f matcher on the room scene through the CLI (debug,
    resume), time the CLI's step with and without the loader's prefetch,
    take coarse and timed c2f steps, localize with the checkpoint -> launch
    counts."""
    import copy
    import tempfile

    from nerfmatch_tpu_torch.config import load_yaml_config, save_config
    from nerfmatch_tpu_torch.cli.train_nerfmatch import main as train_cli
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
    from nerfmatch_tpu_torch.ops.matching import pad_matches_with_gt
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import (
        BATCH_KEYS, C2F_KEYS, C2FTrainStep, CoarseTrainStep, coarse_features,
        build_matcher, init_config_odir, to_device)
    from nerfmatch_tpu_torch.utils.metrics import compute_matching_loss
    from nerfmatch_tpu_torch.utils.optim import (config_adaptive_lr,
                                                 init_optimizer,
                                                 trainable_parameters)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        cache, pairs = write_match_scene(renderer, nerf_cfg, dev, root,
                                         n_frames, size)
        shapes = {k: v.shape for k, v in np.load(
            next(cache.glob("*.npy")), allow_pickle=True).item().items()}
        log(f"matcher scene: {n_frames} frames {size}x{size} and their scene "
            f"points ({cache.name}: {shapes}) in {time.perf_counter() - t0:.1f}"
            f" s")
        assert shapes["pt_feat"] == ((size // 8) ** 2, 256)

        def config(name):
            cfg, _ = load_yaml_config(ROOT / "configs/nerfmatch" / name)
            cuts = {"data.data_dir": str(root), "data.scenes": ["room"],
                    "data.scene_anno_path": str(root / "#scene" /
                                                "transforms_#split.json"),
                    "data.scene_dir": str(cache),
                    "data.train_pair_txt": str(pairs),
                    "data.test_pair_txt": str(pairs),
                    "exp.odir": str(root / "out"), "exp.max_epochs": 2}
            if size != 480:
                cuts["data.img_wh"] = [size, size]
            for key, value in cuts.items():
                sec, attr = key.split(".")
                log(f"  {name} cut: {key}: {getattr(getattr(cfg, sec), attr)!r}"
                    f" -> {value!r}")
                setattr(getattr(cfg, sec), attr, value)
            cfg.data.seed = cfg.exp.seed
            return cfg

        cfg = config("nerfmatch_7scenes_sfm_c2f.yaml")
        save_config(root / "c2f.yaml", cfg)
        argv = ["--config", str(root / "c2f.yaml"), "--stage", "c2f",
                "--debug"]
        t0 = time.perf_counter()
        out_cfg, m1 = train_cli(argv)
        t1 = time.perf_counter()
        w1 = {k: v.detach().clone() for k, v in m1.state_dict().items()}
        _, m2 = train_cli(argv)
        t2 = time.perf_counter()
        assert all(torch.equal(v, w1[k]) for k, v in m2.state_dict().items()), \
            "resume changed the weights"
        ckpt = latest_checkpoint(init_config_odir(out_cfg, False) /
                                 "checkpoints", name="last")
        assert ckpt is not None and ckpt.name == "last_2", ckpt
        log(f"cli train_nerfmatch --stage c2f --debug: 2 epochs x 5 steps of "
            f"batch {cfg.exp.batch_size} + 2 val batches each in "
            f"{t1 - t0:.1f} s (lr {out_cfg.optim.lr:g} = clr * batch / cbs); "
            f"resumed at epoch 2 in {t2 - t1:.1f} s ({ckpt.name})")
        del m1, m2

        # The loader's prefetch: host time to build a batch, and the CLI's
        # step (the trainer's wall ms/step over one epoch of 20 steps) with
        # batches built in the loop (num_workers 0) or in a thread (1).
        it = iter(init_data_loader(cfg.data, cfg.exp.batch_size, split="train"))
        t0 = time.perf_counter()
        for _ in range(10):
            next(it)
        host_s = (time.perf_counter() - t0) / 10
        cli_ms = {}
        for workers in (0, 1):
            c = copy.deepcopy(cfg)
            c.exp.num_workers, c.exp.max_epochs = workers, 1
            c.exp.resume_version = f"workers{workers}"
            c.data.epoch_sample_num = 20 * c.exp.batch_size
            save_config(root / "workers.yaml", c)
            out, _ = train_cli(["--config", str(root / "workers.yaml"),
                                "--stage", "c2f"])
            metrics = init_config_odir(out, False) / "metrics.jsonl"
            cli_ms[workers] = next(
                r["train/ms_per_step"] for r in map(
                    json.loads, metrics.read_text().splitlines())
                if "train/ms_per_step" in r)
        log(f"loader: {host_s:.4f} s of host time per batch of "
            f"{cfg.exp.batch_size}; CLI {cli_ms[0]:.1f} ms/step with "
            f"num_workers 0, {cli_ms[1]:.1f} with 1 (prefetch thread)")

        def batches(cfg, keys, n):
            it = iter(init_data_loader(cfg.data, cfg.exp.batch_size,
                                       split="train", num_workers=1))
            return [to_device(next(it), keys, dev) for _ in range(n)]

        def trainer(cfg, coarse):
            model = build_matcher(cfg, coarse, torch.Generator().manual_seed(
                seed)).to(dev)
            opt = init_optimizer(cfg.optim, trainable_parameters(model),
                                 lr=config_adaptive_lr(cfg)[0])
            return model, opt

        ccfg = config("nerfmatch_7scenes_sfm_coarse.yaml")
        model, opt = trainer(ccfg, True)
        step = CoarseTrainStep(model, opt)
        closs = [float(step.step(b)["loss"])
                 for b in batches(ccfg, BATCH_KEYS, 5)]
        log(f"coarse: 5 CoarseTrainStep steps at batch "
            f"{ccfg.exp.batch_size}, loss {[round(x, 5) for x in closs]}")
        assert np.isfinite(closs).all(), closs
        del model, opt, step

        model, opt = trainer(cfg, False)
        step = C2FTrainStep(model, opt,
                            generator=torch.Generator(dev).manual_seed(seed))
        # Five batches cycled: the first and the last 5 of 32 steps see the
        # same five.  The loss on them, each with one fixed list of GT
        # matches, before and after the timed steps shows whether training
        # lowered it, whatever each step's own GT draw.
        data = batches(cfg, C2F_KEYS, 5)
        no_pred = lambda gt: {"j_ids": torch.zeros_like(gt, dtype=torch.long),
                              "mconf": torch.zeros_like(gt),
                              "valid": torch.zeros_like(gt, dtype=torch.bool)}
        gt_lists = [pad_matches_with_gt(no_pred(b["conf_gt"][..., 0]),
                                        b["conf_gt"], generator=step.generator)
                    for b in data]

        def fixed_loss():
            """(total, coarse, fine) loss on the five batches and lists."""
            with torch.no_grad():
                terms = [step.losses(b, mlist=m)[1]
                         for b, m in zip(data, gt_lists)]
            return tuple(np.mean([float(t[k]) for t in terms])
                         for k in ("loss", "coarse_loss", "fine_loss"))

        def coarse_term(clamp):
            """Mean focal loss on the five batches, and the share of GT
            positives whose conf clears the clamp (1e-6)."""
            loss, above = 0.0, 0.0
            for b in data:
                conf = coarse_features(model, *(b[k] for k in BATCH_KEYS[:5]))[0]
                term = compute_matching_loss(conf, b["conf_gt"], clamp=clamp)
                if torch.is_grad_enabled():
                    term.backward()
                loss += float(term.detach()) / len(data)
                above += float((conf[b["conf_gt"] == 1] > 1e-6).float().mean()
                               ) / len(data)
            return loss, above

        # From a random init every conf of the 3600 x 3600 dual softmax is
        # ~1e-7: the c2f's clamped focal loss sits at its clamp and sends the
        # coarse path no gradient.  The reference starts Full from ImageNet
        # or a trained Mini; here the same model first takes coarse steps
        # with the Mini's unclamped loss (CoarseTrainStep), until GT
        # positives clear the clamp.
        with torch.no_grad():
            warm_before = coarse_term(clamp=False)
        warm = CoarseTrainStep(model, opt)
        for i in range(warm_steps):
            warm.step(data[i % len(data)])
        with torch.no_grad():
            warm_after = coarse_term(clamp=False)
        model.zero_grad(set_to_none=True)
        clamped = coarse_term(clamp=True)[0]
        gnorm = {}
        for name, p in model.named_parameters():
            if p.grad is not None:
                top = name.split(".")[0]
                gnorm[top] = gnorm.get(top, 0.0) + float(p.grad.norm()) ** 2
        gnorm = {k: v ** 0.5 for k, v in gnorm.items()}
        model.zero_grad(set_to_none=True)
        log(f"coarse warm-up at c2f width: {warm_steps} CoarseTrainStep steps,"
            f" unclamped focal loss {warm_before[0]:.4f} -> {warm_after[0]:.4f}"
            f", GT positives above the clamp {warm_before[1]:.4f} -> "
            f"{warm_after[1]:.4f}; the c2f's clamped coarse term "
            f"{clamped:.4f}, its gradient norm by module " + json.dumps(
                {k: float(f"{v:.4g}") for k, v in gnorm.items()}))
        assert warm_after[0] < warm_before[0], (warm_before, warm_after)
        # The clamped coarse term alone reaches the trunk (kernels 8-9) and
        # the attention layers (kernel 4).
        for mod in ("backbone", "pt_sa", "coarse_former"):
            assert 0 < gnorm.get(mod, 0) < float("inf"), (mod, gnorm)

        before = fixed_loss()
        hist = [step.step(data[i % 5]) for i in range(2)]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        hist += [step.step(data[i % 5]) for i in range(2, 2 + timed_steps)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                step.step(data[i % 5])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        launches = dict(LAUNCHES)
        log(f"launches during matcher training: {json.dumps(launches)}")
        missing = [k for k in MATCH_KERNELS if launches[k] == 0]
        assert not missing, f"kernels never launched in matcher training: " \
            f"{missing}"
        after = fixed_loss()
        loss, closs, floss, pos = ([float(m[k]) for m in hist] for k in (
            "loss", "coarse_loss", "fine_loss", "coarse_pos_ratio"))
        # Kernel rows only: a user annotation's range (the optimizer step)
        # spans kernels that have rows of their own.
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
        dev_ms = sum(e.self_device_time_total for e in ka) / 1e3
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:16]
        log(f"matcher training: {step_ms:.1f} ms/step, "
            f"{cfg.exp.batch_size / step_ms * 1e3:.2f} pairs/s over "
            f"{timed_steps} c2f steps of batch {cfg.exp.batch_size} "
            f"({size}x{size}, {(size // 8) ** 2} tokens x {(size // 8) ** 2} "
            f"points); loss on the 5 batches with fixed GT match lists "
            f"{before[0]:.4f} -> {after[0]:.4f} (coarse {before[1]:.4f} -> "
            f"{after[1]:.4f}, fine {before[2]:.4f} -> {after[2]:.4f}); "
            f"per-step coarse loss mean of the "
            f"first / last 5 {np.mean(closs[:5]):.4f} / {np.mean(closs[-5:]):.4f}"
            f", fine {np.mean(floss[:5]):.4f} / {np.mean(floss[-5:]):.4f} "
            f"with {np.mean(pos[:5]):.2f} / {np.mean(pos[-5:]):.2f} % of the "
            f"listed matches within coarse_dthres, total "
            f"{np.mean(loss[:5]):.4f} / {np.mean(loss[-5:]):.4f}; peak "
            f"memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; profiled "
            f"3 steps: wall {wall:.1f} ms, device {dev_ms:.1f} ms, idle share "
            f"{max(0.0, 1 - dev_ms / wall):.2f}")
        log("  device time by kernel (ms, 3 steps): " + json.dumps(
            {e.key[:60]: round(e.self_device_time_total / 1e3, 2)
             for e in top}))
        groups = {"attention backward (kernel 4)": ("attn_bwd",),
                  "attention forward (kernel 3)": ("attention_",),
                  "StarReLU + dwconv (kernels 7-9)": ("dw_star",),
                  "GEMMs": ("gemm", "Gemm"), "cuDNN convs": ("conv", "cudnn"),
                  "optimizer": ("multi_tensor",)}
        by_group = {g: 0.0 for g in (*groups, "other")}
        for e in ka:
            g = next((g for g, keys in groups.items()
                      if any(k in e.key for k in keys)), "other")
            by_group[g] += e.self_device_time_total / 1e3 / 3
        log("  device time by group (ms per step): " + json.dumps(
            {g: round(v, 2) for g, v in by_group.items()}))
        assert np.isfinite(loss).all(), loss
        assert after[0] < before[0], (before, after)
        # The per-step coarse loss must fall too.  The per-step total need
        # not: as the coarse matches improve, more of each step's predicted
        # matches fall within coarse_dthres of their GT and enter the fine
        # loss, each with several times a GT-padded match's pixel error.
        # The fixed-list loss above is the fine part's learning check.
        assert np.mean(closs[-5:]) < np.mean(closs[:5]), closs
        del model, opt, step, data

        evaluator = NeRFMatchEvaluator(
            cfg, state_dict=torch.load(ckpt / "model.pt", map_location="cpu",
                                       weights_only=True), device=dev)
        with torch.no_grad():
            req = make_request(renderer, 0.3, dev, size)
            res = evaluator.eval_batch(scene_points(renderer, [req], size),
                                       renderer=renderer, iters=2, mutual=True,
                                       solver="colmap", rthres=10.0)
        c2w, r_err, t_err = res["c2w_est"][0], res["R_err"][0], res["t_err"][0]
        assert (c2w is None and r_err == t_err == float("inf")) or (
            np.isfinite(c2w).all() and np.isfinite([r_err, t_err]).all())
        log(f"localized with {ckpt.name}: {res['num_matches'][0]} matches, "
            f"R_err {r_err:.2f} deg, t_err {t_err:.3f}")
    return launches


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    smi = phase_environment()
    from nerfmatch_tpu_torch.config import load_yaml_config
    from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.train.checkpoint import (load_npz_params,
                                                      state_dict_from_jax)

    phase_build()
    dev = torch.device("cuda", 0)
    nerf_cfg, _ = load_yaml_config(ROOT / "configs/nerf/nerf_7scenes_mip_sfm.yaml")
    renderer = NerfRenderer(nerf_cfg, stop_layer=3)
    renderer.load_state_dict(state_dict_from_jax(load_npz_params(
        ROOT / "pretrained/synthetic_room_nerf.npz")), strict=True)
    renderer = renderer.to(dev).eval()
    log(f"renderer: trunk_int8={renderer.cfg.trunk_int8} "
        f"early_term_eps={renderer.cfg.early_term_eps} feat_layer=3")
    with torch.no_grad():
        rows = phase_kernels(renderer, dev)
    rows.update(phase_train_kernels(renderer, dev))
    with torch.no_grad():
        rows.update(phase_matcher_kernels(dev))
    torch.cuda.empty_cache()

    match_cfg, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    evaluator = NeRFMatchEvaluator(
        match_cfg, device=dev,
        generator=torch.Generator().manual_seed(args.seed))
    log(f"matcher: {evaluator.model.cfg}")
    with torch.no_grad():
        launches, results = phase_serving(renderer, evaluator, dev)
        phase_check(evaluator, results[0][0])
    launches.update({k: v for k, v in phase_training(renderer, dev,
                                                     args.seed).items()
                     if k not in SERVING_KERNELS})
    # The new kernels' counts come from matcher training, where all four run.
    match = phase_matcher_training(renderer, nerf_cfg, dev, args.seed)
    launches.update({k: match[k] for k in MATCH_KERNELS if k != "attention"})

    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=launches[n], **rows[n])
               for n, (src, rep) in KERNEL_SOURCES.items()]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
