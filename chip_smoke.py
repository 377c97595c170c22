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
4. serving: the room NeRF (``pretrained/synthetic_room_nerf.npz``) and the
   production c2f matcher (random weights from a seed) localize three query
   photos (the port's own 480x480 renders on the room's camera circle)
   against scene points rendered at nearby database poses, through
   ``NeRFMatchEvaluator.eval_batch(iters=2, mutual=True)``, plus one
   ``eval_bs=2`` request; the launch counters must show every kernel ran;
   one request's matches are checked against the plain path on the CPU;
5. training: a 24-frame 480x480 scene rendered from the room NeRF is
   written in the dataset's layout; ``cli.train_nerf --debug`` trains on it
   with ``configs/nerf/nerf_7scenes_mip_sfm.yaml`` (only the data paths and
   the output dir changed) and resumes; ``NerfTrainer`` then takes 50 steps
   of 9216 rays from a fresh initialization (loss must fall, PSNR rise);
   the launch counters must show the train kernels and the resample ran;
   the last checkpoint loads into a serving renderer that renders one ds-8
   scene-point grid through the eval kernels.

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
}
SERVING_KERNELS = ("render_coarse", "render_fine", "resample", "attention")
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

    from nerfmatch_tpu.config import load_yaml_config, save_config
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
        # Kernel rows only: an op's device time already holds its kernels.
        ka = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    smi = phase_environment()
    from nerfmatch_tpu.config import load_yaml_config
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
