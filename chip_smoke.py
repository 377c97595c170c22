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
4. serving: the room NeRF (``pretrained/synthetic_room_nerf.npz``) and the
   production c2f matcher (random weights from a seed) localize three query
   photos (the port's own 480x480 renders on the room's camera circle)
   against scene points rendered at nearby database poses, through
   ``NeRFMatchEvaluator.eval_batch(iters=2, mutual=True)``, plus one
   ``eval_bs=2`` request; the launch counters must show every kernel ran;
   one request's matches are checked against the plain path on the CPU.

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
}
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
    missing = [k for k, n in launches.items() if n == 0]
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

    match_cfg, _ = load_yaml_config(
        ROOT / "configs/nerfmatch/nerfmatch_7scenes_sfm_c2f.yaml")
    evaluator = NeRFMatchEvaluator(
        match_cfg, device=dev,
        generator=torch.Generator().manual_seed(args.seed))
    log(f"matcher: {evaluator.model.cfg}")
    with torch.no_grad():
        launches, results = phase_serving(renderer, evaluator, dev)
        phase_check(evaluator, results[0][0])

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
