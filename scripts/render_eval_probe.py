"""What the bf16 render stage's kernel (kernel 1, ``csrc/render_eval.cu``) is
made of, on one NVIDIA GPU.

    python3 scripts/render_eval_probe.py [--parent-source FILE]

Builds ``nerfmatch_tpu_torch/csrc/render_eval.cu`` once per variant below,
each an edited copy of the source (``PATCHES``: every edit must match the
source exactly once), one ``nvcc`` each, all started together, into
``build/render_eval_probe/<variant>/``:

* ``shipped``: as the package builds it;
* ``live_gate``: a warpgroup without a tile skips the ring waits and the
  ``wgmma`` (a test of ``live`` around them; shipped, it multiplies on
  whatever it holds);
* ``no_mma``: the products issue no ``wgmma`` (the ring, the encoding,
  the epilogues and the compositing stay);
* ``no_ring``: no weight slices after the prologue and no waits for them
  (the products run on whatever the slots hold);
* ``bare``: neither (what remains: the encoding, the epilogues, the
  compositing, the barriers and the tile turnover);
* ``no_tap``: the fine stage skips the tap layer's second pass (its slices
  and its product; the descriptor sums read the views' accumulator);
* ``ring_7_9``: 7 weight slots in the fine stage and 9 in the coarse (6 and
  7 shipped);
* ``ring_5``: 5 slots in both;
* ``no_ipe``: the encoding skips its ``sinf`` / ``expf`` (it stores the
  scaled means and variances instead);
* ``no_epi``: the trunk's epilogues keep the registers they had (no bias,
  ReLU or rounding into the next layer's A);
* ``pair_sync``: one block barrier every second weight slice, refilling
  two slots at it;
* ``slice64``: 64-row weight slices (3 slots in the fine stage, 5 in the
  coarse), the encoding rows padded to 128, from images of their own
  (``images64``).

Then, on phase 3's stages of ``chip_smoke.py`` (the room's MLPs, 9216 rays x
128 samples, the fine stage's z from the plain coarse stage's weights), it
runs ``render_stage`` with each build's library in place of the package's,
coarse and fine at eps 0 and 1e-4, three times each under
``torch.profiler``, and prints the device ms of ``render_eval_kernel`` a
call, one JSON line per variant after each build's ptxas lines
(registers, spills, and any note that ``wgmma`` was serialized) and the
card's name and power limit.  The shipped build's outputs must equal the
package's bit for bit; so should those of ``live_gate``, the ring depths,
``pair_sync`` and ``slice64`` (``same_bits``); the others compute something else and
are only timed.  ``--parent-source FILE``: also build FILE, an earlier
``render.cu`` whose ``nm_render_forward`` runs the bf16 stages (e.g.
``git show <parent>:nerfmatch_tpu_torch/csrc/render.cu``), and time it on
the same inputs with the fragments it reads.  Compare within one run only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import render_kernel as rk  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import render_train_kernel as rtk  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (  # noqa: E402
    resample_z_plain)
from train_bwd_probe import build_variants, profile_ms  # noqa: E402

SRC = "render_eval.cu"
ENTRIES = ("nm_render_eval_forward", "nm_render_eval_smem")
_SS = "        wgmma_ss<N, 0>(acc, desc128(enc_w + (ks >> 2) * L::kEncBlock"
_RS = "        wgmma_rs<N, 1>(acc, a[s * KK + kk], desc128("
_IPE = """        const float damp = expf(-0.5f * y);
        const __nv_bfloat16 v[2] = {__float2bfloat16(damp * sinf(x)),
                                    __float2bfloat16(damp * sinf(x + kHalfPi))};
"""
_RING = "static constexpr int kRing = FINE && HID > 64 ? 6 : 7;"
_Q = """  const int Q = FINE ? Qt + 2 * KS + (tap_enc ? kEncSlices : 0) + (feat_layer > 0 ? KS : 0)
                     : Qt;
"""
_WAIT = """      mbar_wait(full0 + 8 * (q % R), (q / R) & 1);
      wgmma_fence();
"""
_END = """      wgmma_commit();
      wgmma_wait<1>();
"""
# Variants that compute what the package computes: their outputs are
# compared with it bit for bit ("same_bits").
SAME_BITS = ("shipped", "live_gate", "ring_7_9", "ring_5", "pair_sync",
             "slice64")
PATCHES = {
    "shipped": [],
    "live_gate": [
        ("  auto product = [&](auto ne_c",
         "  bool live_p = false;\n  auto product = [&](auto ne_c"),
        ("    const bool live = tile >= 0;   // this warpgroup has a chunk\n",
         "    const bool live = tile >= 0;\n    live_p = live;\n"),
        (_WAIT, "      if (live_p) {\n" + _WAIT.replace("\n      ", "\n        ")
         .replace("      mbar", "        mbar", 1) + "      }\n"),
        (_END, "      if (live_p) {\n" + _END.replace("      wgmma", "        wgmma")
         + "      }\n"),
        (_SS, _SS.replace("wgmma_ss", "if (live_p) wgmma_ss")),
        (_RS, _RS.replace("wgmma_rs", "if (live_p) wgmma_rs")),
        ("    wgmma_wait<0>();\n  };", "    if (live_p) wgmma_wait<0>();\n  };")],
    "no_mma": [(_SS, "        (void)slot;\n        if (0) " + _SS.lstrip()),
               (_RS, "        if (0) " + _RS.lstrip())],
    "no_ring": [("      if (tid == 0) load_slice(q + R - 2);\n", ""),
                ("      mbar_wait(full0 + 8 * (q % R), (q / R) & 1);\n", ""),
                ("  if (tid == 0)\n    for (int s = q; s < q + R - 2; ++s) "
                 "mbar_wait(full0 + 8 * (s % R), (s / R) & 1);\n", "")],
    "bare": [],   # no_mma's and no_ring's edits, filled in below
    "no_tap": [(_Q, "  const int Q = FINE ? Qt + 2 * KS : Qt;\n"),
               ("      layer_product(feat_layer);\n", "")],
    "ring_7_9": [(_RING, _RING.replace("? 6 : 7", "? 7 : 9"))],
    "ring_5": [(_RING, _RING.replace("? 6 : 7", "? 5 : 5"))],
    "no_ipe": [(_IPE, _IPE.replace("damp * sinf(x)", "x").replace(
        "damp * sinf(x + kHalfPi)", "y"))],
    "no_epi": [("            a[j >> 1][2 * (j & 1) + h] = pack_bf16(v0, v1);\n", "")],
    "slice64": [
        ("constexpr int kSliceK = 32;", "constexpr int kSliceK = 64;"),
        ("constexpr int kEncSlices = kEncMax / kSliceK;",
         "constexpr int kEncSlices = (kEncMax + kSliceK - 1) / kSliceK;"),
        (_RING, _RING.replace("? 6 : 7", "? 3 : 5")),
        ("static_assert(HID % 64 == 0 && KS >= 2,", "static_assert(HID % 64 == 0 && KS >= 1,"),
        ("""  for (int i = tid; i < 2 * kWgRows * (kEncMax - enc_dim); i += kEvalThreads) {
    const int row = i / (kEncMax - enc_dim), k = enc_dim + i % (kEncMax - enc_dim);""",
         """  for (int i = tid; i < 2 * kWgRows * (128 - enc_dim); i += kEvalThreads) {
    const int row = i / (128 - enc_dim), k = enc_dim + i % (128 - enc_dim);""")],
    "pair_sync": [
        ("    for (int s = 0; s < R - 2; ++s) load_slice(s);",
         "    for (int s = 0; s < R - 3; ++s) load_slice(s);"),
        ("""      __syncthreads();   // batch q - 2 done everywhere: its slot is free
      if (tid == 0) load_slice(q + R - 2);
""", """      if ((q & 1) == 0) {
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


def images64(mlp):
    """``forward_images`` for 64-row slots, the encoding rows padded to 128
    (two slots): the ``slice64`` variant's weights."""
    cfg = mlp.cfg
    enc, hid = cfg.xyz_dim, cfg.hid_dim

    def img(w, k=None, n=None):
        wt = w.detach().t()
        wt = torch.nn.functional.pad(wt, (0, (n or wt.shape[1]) - wt.shape[1],
                                          0, (k or wt.shape[0]) - wt.shape[0]))
        return rtk.slot_images(wt, rows=64).reshape(-1)

    imgs = []
    for i, lin in enumerate(mlp.pts_linears):
        w = lin.weight
        if i == 0 or (i - 1) in cfg.skips:
            imgs.append(img(w[:, :enc], k=128))
        if i > 0:
            imgs.append(img(w[:, enc:] if (i - 1) in cfg.skips else w))
    imgs += [img(mlp.feature_linear.weight),
             img(mlp.views_linears[0].weight[:, :hid], n=max(hid // 2, 64))]
    return torch.cat(imgs)


PATCHES["bare"] = PATCHES["no_mma"] + PATCHES["no_ring"]


# Variants that read other weight images than pack_mlp's.
IMAGES = {"slice64": images64}


def parent_library(path):
    """An earlier render.cu (its bf16 stages on mma.sync), built alone."""
    out_dir = ROOT / "build" / "render_eval_probe" / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "render.cu").write_text(Path(path).read_text())
    so = out_dir / "render.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", "-shared",
           "-o", str(so), str(out_dir / "render.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc parent failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.nm_render_forward.argtypes = kernels._SIGNATURES["nm_render_forward"]
    lib.nm_render_forward.restype = ctypes.c_int
    return lib


def run_parent(lib, mlp, rays, z, fine, eps, frags):
    """The earlier kernel's bf16 stage (nm_render_forward, no int8 trunk)."""
    cfg, n, S = mlp.cfg, z.shape[0], z.shape[1] - 1
    f32 = dict(device=rays.device, dtype=torch.float32)
    out = [torch.empty(n, S, **f32), torch.empty(n, **f32), torch.empty(n, **f32)]
    if fine:
        out += [torch.empty(n, 3, **f32), torch.empty(n, cfg.hid_dim, **f32),
                torch.empty(n, 3, **f32)]
    ptr = lambda p: None if p is None else p.data_ptr()
    ptrs = (ctypes.c_void_p * (len(frags) + 2))(*map(ptr, frags), rays.data_ptr(),
                                                z.data_ptr())
    outs = [o.data_ptr() for o in out] + [None] * (6 - len(out))
    err = lib.nm_render_forward(
        ptrs, None, n, cfg.hid_dim, cfg.layer_num, 3, -1, 15, 4, S, 1.0,
        math.log(eps) if eps > 0 else -math.inf, 0, int(fine), *outs, None,
        kernels.stream_ptr(rays.device))
    kernels.check(err, "render (parent)")


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
    p.add_argument("--parent-source", help="an earlier render.cu to time too")
    args = p.parse_args()
    smi = chip_smoke.phase_environment()
    dev = torch.device("cuda", 0)
    libs = build_variants(PATCHES, "render_eval_probe", SRC, ENTRIES)
    parent = parent_library(args.parent_source) if args.parent_source else None
    renderer = chip_smoke.load_room_renderer(dev)
    rays = chip_smoke.camera_rays(chip_smoke.room_c2w(0.4), 96, dev)
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4)
    cases = []
    with torch.no_grad():
        for eps in (0.0, 1e-4):
            w = rk.render_stage_plain(renderer.nerf_coarse, rays, z, fine=False,
                                      early_term_eps=eps, **kw)["weights"]
            zf = resample_z_plain(z, w).contiguous()
            cases += [("coarse", eps, renderer.nerf_coarse, z, False),
                      ("fine", eps, renderer.nerf_fine, zf, True)]
        packed = {id(m): rk.pack_mlp(m) for m in (renderer.nerf_coarse,
                                                  renderer.nerf_fine)}
        ref = {(name, eps): rk.render_stage(mlp, rays, zz, fine=fine,
                                            early_term_eps=eps,
                                            packed=packed[id(mlp)], **kw)
               for name, eps, mlp, zz, fine in cases}
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
            for stage, eps, mlp, zz, fine in cases:
                pk = packed[id(mlp)]
                if name in IMAGES:
                    pk = [IMAGES[name](mlp), *pk[1:]]
                call = lambda: rk.render_stage(mlp, rays, zz, fine=fine,
                                               early_term_eps=eps, packed=pk,
                                               **kw)
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
        if parent is not None:
            row = {"variant": "parent (render.cu, mma.sync)"}
            frags = {id(m): rk.pack_mlp_fragments(m) for m in (
                renderer.nerf_coarse, renderer.nerf_fine)}
            for stage, eps, mlp, zz, fine in cases:
                call = lambda: run_parent(parent, mlp, rays, zz, fine, eps,
                                          frags[id(mlp)])
                with torch.no_grad():
                    ms = profile_ms(call, {"render_kernel": "k"})
                row[f"{stage}_eps{eps:g}"] = round(ms["k"], 4)
            print(json.dumps(row), flush=True)
    finally:
        kernels._LIB = package_lib


if __name__ == "__main__":
    main()
