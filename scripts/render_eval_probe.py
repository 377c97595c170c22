"""What the render stage's kernel (kernels 1 and 1b, ``csrc/render_eval.cu``)
is made of, on one NVIDIA GPU.

    python3 scripts/render_eval_probe.py [--parent-source FILE] [--variants A,B]

Builds ``nerfmatch_tpu_torch/csrc/render_eval.cu`` once per variant below,
each an edited copy of the source (``PATCHES``: every edit must match the
source exactly once), one ``nvcc`` each, all started together, into
``build/render_eval_probe/<variant>/``:

* ``shipped``: as the package builds it;
* ``live_gate``: a warpgroup without a tile skips the ring waits and the
  bf16 ``wgmma`` (a test of ``live`` around them; shipped, it multiplies on
  whatever it holds);
* ``no_mma``: the products issue no ``wgmma``, bf16 or s8 (the ring, the
  encoding, the epilogues and the compositing stay);
* ``no_ring``: no weight slices after the prologue and no waits for them
  (the products run on whatever the slots hold);
* ``bare``: neither (what remains: the encoding, the epilogues, the
  compositing, the barriers and the tile turnover);
* ``no_tap``: the fine stage skips the tap layer's second pass (its slices
  and its product; the descriptor sums read the views' accumulator);
* ``ring_7_9``: 7 weight slots in the bf16 fine stage and 9 in the coarse
  stages (6 and 7 shipped);
* ``ring_5``: 5 slots in every stage;
* ``int8_ring_6``: 6 slots in the int8 fine stage (4 shipped; its shared
  memory then leaves the L1 cache 28 KB instead of 60);
* ``no_kinit``: the first s8 product of a chain reads its accumulator
  (``wgmma_rs8`` / ``wgmma_ss8`` without ``kInit``), so the compiler keeps
  the old values live until it;
* ``no_fence``: the int8 epilogues without ``fence8``'s ``__syncwarp``
  (their row loads may all be issued at once);
* ``no_ipe``: the bf16 encoding skips its ``sinf`` / ``expf`` (it stores
  the scaled means and variances instead);
* ``no_epi``: the bf16 trunk's epilogues keep the registers they had (no
  bias, ReLU or rounding into the next layer's A);
* ``pair_sync``: one block barrier every second weight slice, refilling
  two slots at it.

Then, on phase 3's stages of ``chip_smoke.py`` (the room's MLPs, 9216 rays x
128 samples, the fine stage's z from the plain coarse stage's weights), it
runs ``render_stage`` with each build's library in place of the package's,
coarse and fine with a bf16 trunk at eps 0 and 1e-4, and for ``shipped``,
``no_mma`` and ``bare`` also phase 3d's int8 stages (scales from the first
1024 rays; the coarse stage of ``'coarse'`` and the fine stages of
``'both'`` and ``'posttap'``, their z from the plain int8 coarse stage),
three times each under ``torch.profiler``, and prints the device ms of
``render_eval_kernel`` a call, one JSON line per variant after each build's
ptxas lines (registers, spills, and any note that ``wgmma`` was serialized)
and the card's name and power limit.  The shipped build's outputs must
equal the package's bit for bit; so should those of ``live_gate``, the
ring depths and ``pair_sync`` on the bf16 stages (``same_bits``); the
others compute something else and are only timed.  ``--parent-source
FILE``: also build FILE, an earlier ``render.cu`` (its ``nm_render_forward``
runs the int8 stages on ``mma.sync``), with the headers beside it (e.g.
``git archive <parent> nerfmatch_tpu_torch/csrc`` unpacked, FILE its
``render.cu``), and time its int8 stages on the same inputs with the
fragments it reads (``parent_fragments``), its error against the package's
at eps 1e-4 beside.  ``--parent-eval DIR``: also build DIR's
``render_eval.cu`` (an earlier ``csrc`` whose C entry has no ``feat_max``
argument, e.g. ``git archive <parent> nerfmatch_tpu_torch/csrc`` unpacked),
started beside the package's build, and run every stage above (the lin
composite, bf16 and int8) on it: its outputs against the package's bit for
bit (``same_bits``), its times beside, and the wall seconds of its nvcc
beside the package's build (``build_s``, ``package_build_s``).  ``--variants``: build and time
only these (comma separated, ``none`` for none; each build takes minutes).
Compare within one run only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from nerfmatch_tpu_torch.nerf.model import eval_feat_layer  # noqa: E402
from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import render_kernel as rk  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels.quant import (  # noqa: E402
    calibrate_act_scales, pack_mlp_int8)
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (  # noqa: E402
    resample_z_plain)
from train_bwd_probe import build_variants, profile_ms  # noqa: E402

SRC = "render_eval.cu"
ENTRIES = ("nm_render_eval_forward", "nm_render_eval_smem")
_SS = "        wgmma_ss<N, 0>(acc, desc128(enc_w + (ks >> 2) * L::kEncBlock"
_RS = "        wgmma_rs<N, 1>(acc, a[s * KK + kk], desc128("
_RS8 = """      wgmma_rs8<N, s == 0>(acc, a[2 * s], desc64(slot), 1);
      wgmma_rs8<N>(acc, a[2 * s + 1], desc64(slot + 32), 1);
"""
_SS8 = """      wgmma_ss8<N, NH + s == 0>(acc, desc128(xq_w + 64 * s, 16), desc64(slot), 1);
      if constexpr (s == 0)   // encoding k32 steps 0-1, then 2
        wgmma_ss8<N>(acc, desc128(xq_w + 32, 16), desc64(slot + 32), 1);
"""
_SKIP8 = """          wgmma_ss8<64, true>(accs, desc128(xq_w, 16), desc64(e0 + nb * 4096), 0);
          wgmma_ss8<64>(accs, desc128(xq_w + 32, 16), desc64(e0 + nb * 4096 + 32), 1);
          wgmma_ss8<64>(accs, desc128(xq_w + 64, 16), desc64(e1 + nb * 4096), 1);
"""
_IPE = """        const float damp = expf(-0.5f * y);
        const __nv_bfloat16 v[2] = {__float2bfloat16(damp * sinf(x)),
                                    __float2bfloat16(damp * sinf(x + kHalfPi))};
"""
_RING = "static constexpr int kRing = FINE && HID > 64 ? (Q8 ? 4 : 6) : 7;"
_WAIT = """    mbar_wait(full0 + 8 * (q % R), (q / R) & 1);
    wgmma_fence();
"""
_END = """    wgmma_commit();
    wgmma_wait<1>();
"""
# Variants that compute what the package computes: their outputs are
# compared with it bit for bit ("same_bits").
SAME_BITS = ("shipped", "live_gate", "ring_7_9", "ring_5", "int8_ring_6",
             "pair_sync", "no_kinit", "no_fence")
# Variants whose int8 stages are timed too.
INT8_VARIANTS = ("shipped", "no_mma", "bare", "int8_ring_6", "no_kinit",
                 "no_fence")
PATCHES = {
    "shipped": [],
    "live_gate": [
        ("  auto begin = [&]() {", "  bool live_p = false;\n  auto begin = [&]() {"),
        ("    const bool live = tile >= 0;   // this warpgroup has a chunk\n",
         "    const bool live = tile >= 0;\n    live_p = live;\n"),
        (_WAIT, "    if (live_p) {\n" + _WAIT.replace("\n    ", "\n      ")
         .replace("    mbar", "      mbar", 1) + "    }\n"),
        (_END, "    if (live_p) {\n" + _END.replace("    wgmma", "      wgmma")
         + "    }\n"),
        (_SS, _SS.replace("wgmma_ss", "if (live_p) wgmma_ss")),
        (_RS, _RS.replace("wgmma_rs", "if (live_p) wgmma_rs")),
        ("      end();\n    }\n    wgmma_wait<0>();\n  };\n  // The same for s8",
         "      end();\n    }\n    if (live_p) wgmma_wait<0>();\n  };\n  // The same for s8")],
    "no_mma": [(_SS, "        (void)slot;\n        if (0) " + _SS.lstrip()),
               (_RS, "        if (0) " + _RS.lstrip()),
               (_RS8, "      (void)slot;\n"),
               (_SS8, "      (void)slot;\n"),
               (_SKIP8, "          (void)e0;\n          (void)e1;\n")],
    "no_ring": [("    if (tid == 0) load_slice(q + R - 2);\n", ""),
                ("    mbar_wait(full0 + 8 * (q % R), (q / R) & 1);\n", ""),
                ("  if (tid == 0)\n    for (int s = q; s < q + R - 2; ++s) "
                 "mbar_wait(full0 + 8 * (s % R), (s / R) & 1);\n", "")],
    "bare": [],   # no_mma's and no_ring's edits, filled in below
    "no_tap": [("  const int Q = FINE ? Qt + 2 * KS + n_slices(feat_layer) : Qt;\n",
                "  const int Q = FINE ? Qt + 2 * KS : Qt;\n"),
               ("      if (tap8)\n        q8_layer(feat_layer);\n      else\n"
                "        layer_product(feat_layer);\n", "")],
    "ring_7_9": [(_RING, _RING.replace("(Q8 ? 4 : 6) : 7", "(Q8 ? 4 : 7) : 9"))],
    "ring_5": [(_RING, _RING.replace("(Q8 ? 4 : 6) : 7", "5 : 5"))],
    "int8_ring_6": [(_RING, _RING.replace("(Q8 ? 4 : 6)", "6"))],
    "no_kinit": [
        ("wgmma_rs8<N, s == 0>(acc, a[2 * s], desc64(slot), 1);",
         "wgmma_rs8<N>(acc, a[2 * s], desc64(slot), s != 0);"),
        ("wgmma_ss8<N, NH + s == 0>(acc, desc128(xq_w + 64 * s, 16), desc64(slot), 1);",
         "wgmma_ss8<N>(acc, desc128(xq_w + 64 * s, 16), desc64(slot), NH + s != 0);"),
        ("wgmma_ss8<64, true>(accs,", "wgmma_ss8<64>(accs,")],
    "no_fence": [
        ("    if (Q8 && j > 0 && (j & 7) == 0) __syncwarp();", "    (void)j;"),
        ("          __syncwarp();   // fence8's point: this block's row loads stay here\n", "")],
    "no_ipe": [(_IPE, _IPE.replace("damp * sinf(x)", "x").replace(
        "damp * sinf(x + kHalfPi)", "y"))],
    "no_epi": [("              a[j >> 1][2 * (j & 1) + h] = pack_bf16(v0, v1);\n"
                "              if (last)\n", "              if (last)\n")],
    "pair_sync": [
        ("    for (int s = 0; s < R - 2; ++s) load_slice(s);",
         "    for (int s = 0; s < R - 3; ++s) load_slice(s);"),
        ("""    __syncthreads();   // batch q - 2 done everywhere: its slot is free
    if (tid == 0) load_slice(q + R - 2);
""", """    if ((q & 1) == 0) {
      __syncthreads();   // batches q - 3 and q - 2 done everywhere
      if (tid == 0) {
        load_slice(q + R - 3);
        load_slice(q + R - 2);
      }
    }
"""),
        ("    for (int s = q; s < q + R - 2; ++s) mbar_wait(",
         "    for (int s = q; s < q + R - 3 + (q & 1); ++s) mbar_wait(")],
}
PATCHES["bare"] = PATCHES["no_mma"] + PATCHES["no_ring"]

# The parent kernel's C entry (render.cu's nm_render_forward): params, int8
# params, n_rays, hid, layer_num, feat_layer, int8_from, num_freqs,
# dirs_freqs, samples, var_scale, log_eps, white_bg, fine, out pointers x6,
# int8 debug output, stream.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_ENTRY = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P, _P,
                _P, _P, _P, _P, _P, _P]


def _fragments(w, k_step):
    """(K, N) ``in x out`` weight -> the parent's mma.sync B fragments:
    bf16 m16n8k16 (k_step 16) or s8 m16n8k32 (k_step 32), K zero-padded to
    k_step; entry [ks, nt, lane, r] holds w[k .. k + 32 / k_step - 1, n] with
    k = k_step ks + k_step / 2 r + (k_step / 8) (lane % 4), n = 8 nt + lane
    // 4."""
    K, N = w.shape
    e = k_step // 8                                 # elements a register
    w = torch.nn.functional.pad(w, (0, 0, 0, (-K) % k_step))
    w = w.to(torch.bfloat16 if k_step == 16 else torch.int8)
    w = w.reshape(-1, 2, 4, e, N // 8, 8).permute(0, 4, 5, 2, 1, 3).contiguous()
    return w.view(torch.int32).reshape(-1, N // 8, 32, 2)


def parent_fragments(mlp, q):
    """The parent kernel's (params, int8 params) for ``mlp`` and its int8
    trunk ``q`` (quant.pack_mlp_int8), in its C entry's order."""
    cfg, L = mlp.cfg, mlp.cfg.layer_num
    t = lambda w: w.detach().t().contiguous()
    out = []
    for i, lin in enumerate(mlp.pts_linears):
        w = t(lin.weight)
        parts = ((w, None) if i == 0 else (w[:cfg.xyz_dim], w[cfg.xyz_dim:])
                 if i - 1 in cfg.skips else (None, w))
        out += [None if p is None else _fragments(p, 16) for p in parts]
        out.append(lin.bias.detach().contiguous())
    wv = t(mlp.views_linears[0].weight)
    out += [mlp.alpha_linear.weight.detach().reshape(-1).contiguous(),
            mlp.alpha_linear.bias.detach().contiguous(),
            _fragments(t(mlp.feature_linear.weight), 16),
            mlp.feature_linear.bias.detach().contiguous(),
            _fragments(wv[:cfg.hid_dim], 16), wv[cfg.hid_dim:].contiguous(),
            mlp.views_linears[0].bias.detach().contiguous(),
            t(mlp.rgb_linear.weight), mlp.rgb_linear.bias.detach().contiguous()]
    qptrs = []
    for i in range(L):
        pre, bias = ("s", f"b{i}") if i == L - 1 else ("c", f"B{i}")
        row = lambda k: _fragments(q[k], 32) if k[0] == "w" and k in q else q.get(k)
        keys = (f"w{i}q", f"w{i}sq", f"{pre}{i}", f"{pre}{i}s", bias)
        qptrs += [row(k) if i >= q["start"] else None for k in keys]
    tap = q["tap"]
    qptrs += [q["qenc"], q.get("qh"), q.get(f"iq{tap}") if tap is not None else None]
    return out, qptrs


def parent_library(path):
    """An earlier render.cu (its int8 stages on mma.sync) with the headers
    beside it, built alone."""
    out_dir = ROOT / "build" / "render_eval_probe" / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in [Path(path), *Path(path).parent.glob("*.cuh")]:
        (out_dir / src.name).write_text(src.read_text())
    so = out_dir / "render.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(out_dir / Path(path).name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc parent failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.nm_render_forward.argtypes = PARENT_ENTRY
    lib.nm_render_forward.restype = ctypes.c_int
    return lib


def run_parent(lib, mlp, rays, z, fine, eps, q, packed):
    """The earlier kernel's int8 stage (nm_render_forward) on ``packed``
    (:func:`parent_fragments`)."""
    frags, qfrags = packed
    cfg, n, S = mlp.cfg, z.shape[0], z.shape[1] - 1
    f32 = dict(device=rays.device, dtype=torch.float32)
    out = [torch.empty(n, S, **f32), torch.empty(n, **f32), torch.empty(n, **f32)]
    if fine:
        out += [torch.empty(n, 3, **f32), torch.empty(n, cfg.hid_dim, **f32),
                torch.empty(n, 3, **f32)]
    ptr = lambda p: None if p is None else p.data_ptr()
    ptrs = (ctypes.c_void_p * (len(frags) + 2))(*map(ptr, frags), rays.data_ptr(),
                                                z.data_ptr())
    qarr = (ctypes.c_void_p * len(qfrags))(*map(ptr, qfrags))
    outs = [o.data_ptr() for o in out] + [None] * (6 - len(out))
    err = lib.nm_render_forward(
        ptrs, qarr, n, cfg.hid_dim, cfg.layer_num, 3, q["start"], 15, 4, S, 1.0,
        math.log(eps) if eps > 0 else -math.inf, 0, int(fine), *outs, None,
        kernels.stream_ptr(rays.device))
    kernels.check(err, "render (parent)")
    return out


def start_parent_eval(src_dir):
    """nvcc of ``src_dir``'s render_eval.cu (headers beside it) into
    ``build/render_eval_probe/parent_eval/``, started -> (library path,
    process, its wall seconds once done: a dict filled by a thread)."""
    out_dir = ROOT / "build" / "render_eval_probe" / "parent_eval"
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in [Path(src_dir) / SRC, *Path(src_dir).glob("*.cuh")]:
        (out_dir / src.name).write_text(src.read_text())
    so = out_dir / "render_eval.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(out_dir / SRC)]
    t0, seconds = time.perf_counter(), {}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    waiter = threading.Thread(target=lambda: seconds.setdefault(
        "s", (proc.wait(), time.perf_counter() - t0)[1]))
    waiter.start()
    return so, proc, (waiter, seconds)


class ParentEval:
    """The earlier build's library behind the package's C signature: its
    ``nm_render_eval_forward`` lacks the ``feat_max`` argument (index 15),
    which must be 0 here."""

    def __init__(self, so, proc, timer):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc parent_eval failed:\n{log}")
        timer[0].join()
        self.build_s = timer[1]["s"]
        self.lib = ctypes.CDLL(str(so))
        args = list(kernels._SIGNATURES["nm_render_eval_forward"])
        del args[15]
        self.lib.nm_render_eval_forward.argtypes = args
        self.lib.nm_render_eval_forward.restype = ctypes.c_int

    def nm_render_eval_forward(self, *args):
        assert args[15] == 0, "the earlier kernel has no feat_max"
        return self.lib.nm_render_eval_forward(*args[:15], *args[16:])


def ptxas_lines(log):
    name, out = "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "render_eval_kernel" in name and (
                "Used" in line or "spill" in line or "erializ" in line
                or "Performance" in line):
            tag = name[name.index("render_eval_kernel") + 18:][:24]
            out.append(f"{tag}: {line.strip()}")
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent-source",
                   help="an earlier render.cu (headers beside it) to time too")
    p.add_argument("--parent-eval",
                   help="an earlier csrc dir whose render_eval.cu to compare "
                        "bit for bit")
    p.add_argument("--variants", help="comma-separated variants (default "
                                      "all; 'none' for none)")
    args = p.parse_args()
    smi = chip_smoke.phase_environment()
    dev = torch.device("cuda", 0)
    parent_eval = (start_parent_eval(args.parent_eval) if args.parent_eval
                   else None)
    names = ([] if args.variants == "none" else args.variants.split(",")
             if args.variants else list(PATCHES))
    libs = build_variants({n: PATCHES[n] for n in names}, "render_eval_probe",
                          SRC, ENTRIES)
    parent = parent_library(args.parent_source) if args.parent_source else None
    renderer = chip_smoke.load_room_renderer(dev)
    cmlp, fmlp = renderer.nerf_coarse, renderer.nerf_fine
    rays = chip_smoke.camera_rays(chip_smoke.room_c2w(0.4), 96, dev)
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4)
    tap = eval_feat_layer(fmlp.cfg)
    cases, cases8 = [], []   # (label, eps, mlp, z, fine, int8 trunk)
    with torch.no_grad():
        scales = calibrate_act_scales(renderer, rays[:1024])
        qs = {"coarse": (cmlp, False, pack_mlp_int8(cmlp, scales["coarse"], 0)),
              "both": (fmlp, True, pack_mlp_int8(fmlp, scales["fine"], 0, tap)),
              "posttap": (fmlp, True, pack_mlp_int8(fmlp, scales["fine"],
                                                    tap + 1, tap))}
        for eps in (0.0, 1e-4):
            w = rk.render_stage_plain(cmlp, rays, z, fine=False,
                                      early_term_eps=eps, **kw)["weights"]
            zf = resample_z_plain(z, w).contiguous()
            cases += [("coarse", eps, cmlp, z, False, None),
                      ("fine", eps, fmlp, zf, True, None)]
            w = rk.render_stage_plain(cmlp, rays, z, fine=False, early_term_eps=eps,
                                      int8=qs["coarse"][2], **kw)["weights"]
            zf = resample_z_plain(z, w).contiguous()
            cases8 += [(f"{mode}_int8", eps, mlp, zf if fine else z, fine, q)
                       for mode, (mlp, fine, q) in qs.items()]
        packed = {(id(mlp), id(q)): rk.pack_mlp(mlp, q)
                  for _, _, mlp, _, _, q in cases + cases8}
        ref = {(name, eps): rk.render_stage(mlp, rays, zz, fine=fine, early_term_eps=eps,
                                            int8=q, packed=packed[id(mlp), id(q)], **kw)
               for name, eps, mlp, zz, fine, q in cases + cases8}
    for name in libs:
        log = (ROOT / "build" / "render_eval_probe" / name / "build.log").read_text()
        for line in ptxas_lines(log):
            print(f"ptxas {name} {line}", flush=True)
    print(smi, flush=True)
    package_lib = kernels.library()
    try:
        for name, lib in libs.items():
            kernels._LIB = lib
            row = {"variant": name}
            for stage, eps, mlp, zz, fine, q in cases + (
                    cases8 if name in INT8_VARIANTS else []):
                call = lambda: rk.render_stage(mlp, rays, zz, fine=fine,
                                               early_term_eps=eps, int8=q,
                                               packed=packed[id(mlp), id(q)], **kw)
                with torch.no_grad():
                    if name in SAME_BITS:
                        out = call()
                        same = all(torch.equal(out[k], ref[stage, eps][k])
                                   for k in out)
                        assert same or name != "shipped", "shipped != package"
                        row["same_bits"] = row.get("same_bits", True) and same
                    ms = profile_ms(call, {"render_eval_kernel": "k"})
                row[f"{stage}_eps{eps:g}"] = round(ms["k"], 4)
            print(json.dumps(row), flush=True)
        if parent_eval is not None:
            kernels._LIB = ParentEval(*parent_eval)
            # Both builds started together: the package's (every csrc file,
            # render_eval.cu the longest) and the earlier render_eval.cu.
            row = {"variant": "parent_eval", "same_bits": True,
                   "build_s": round(kernels._LIB.build_s, 1),
                   "package_build_s": round(kernels.BUILD_INFO["seconds"], 1)}
            for stage, eps, mlp, zz, fine, q in cases + cases8:
                call = lambda: rk.render_stage(mlp, rays, zz, fine=fine,
                                               early_term_eps=eps, int8=q,
                                               packed=packed[id(mlp), id(q)], **kw)
                with torch.no_grad():
                    out = call()
                    same = all(torch.equal(out[k], ref[stage, eps][k])
                               for k in out)
                    row["same_bits"] = row["same_bits"] and same
                    row[f"{stage}_eps{eps:g}_same"] = same
                    ms = profile_ms(call, {"render_eval_kernel": "k"})
                row[f"{stage}_eps{eps:g}"] = round(ms["k"], 4)
            print(json.dumps(row), flush=True)
        if parent is not None:
            row = {"variant": "parent (render.cu, mma.sync)"}
            frags = {id(q): parent_fragments(mlp, q) for _, _, mlp, _, _, q in cases8}
            for stage, eps, mlp, zz, fine, q in cases8:
                call = lambda: run_parent(parent, mlp, rays, zz, fine, eps, q,
                                          frags[id(q)])
                with torch.no_grad():
                    if eps > 0:   # the same function as the package's stage
                        out = call()
                        keys = ["weights", "depth", "acc", "rgb", "feat", "pts"]
                        err = max(float((o - ref[stage, eps][k]).abs().max())
                                  / max(1.0, float(ref[stage, eps][k].abs().max()))
                                  for o, k in zip(out, keys))
                        row[f"{stage}_scaled_err"] = float(f"{err:.3e}")
                    ms = profile_ms(call, {"render_kernel": "k"})
                row[f"{stage}_eps{eps:g}"] = round(ms["k"], 4)
            print(json.dumps(row), flush=True)
    finally:
        kernels._LIB = package_lib


if __name__ == "__main__":
    main()
