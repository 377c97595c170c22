"""What the NeRF train-render backward's launches (kernel 6) are made of,
on one NVIDIA GPU.

    python3 scripts/train_bwd_probe.py

Builds ``nerfmatch_tpu_torch/csrc/render_train.cu`` once per variant below,
each an edited copy of the source (``PATCHES``: every edit must match the
source exactly once), one ``nvcc`` each, all started together, into
``build/train_bwd_probe/<variant>/``:

* ``shipped``: as the package builds it;
* ``no_mma``: the trunk backward issues no ``wgmma`` (loads, barriers and
  the elementwise stages stay);
* ``no_ring``: the trunk backward loads no weight slices after its prologue;
* ``no_rows``: the trunk backward neither loads hs / hv rows nor stores its
  gradient rows;
* ``no_epi``: the trunk layers' column sums (the bias gradients) are left
  out;
* ``splits24`` / ``splits32``: the weight-gradient GEMM over 24 / 32 row
  ranges instead of 48.

Then, on phase 3b's stage of ``chip_smoke.py`` (the room's fine MLP, 9216
rays x 128 samples) and the stash of the package's training forward, it
runs ``nm_render_train_backward`` of each build three times under
``torch.profiler`` and prints the device time of each launch (trunk
backward, weight-gradient GEMM, reductions), the mean over the three calls,
one JSON line per variant after the card's name and power limit.  The shipped build's gradients must equal the
package's bit for bit; the probe builds compute something else and are only
timed.  Compare within one run only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import render_train_kernel as rtk  # noqa: E402

# The trunk backward's row lambdas, each with the line after it (the
# forward has a store_rows of its own).
_ROW_LAMBDAS = (
    ("  auto load_rows = [&](const __nv_bfloat16* src, int width, size_t rg0) {\n",
     "    if (tid < kChunkRows) {\n"),
    ("  auto rows_landed = [&]() {\n", "    mbar_wait(bar, hs_phase);\n"),
    ("  auto store_rows = [&](__nv_bfloat16* dst, int width, size_t rg0) {\n",
     "    if (tid < kChunkRows)\n      bulk_store(dst + (rg0 + tid) * width, hs_s"))
_SUMS_TAIL = """        }
        fence_async();
        __syncthreads();
        store_rows(st.g_pre[i], HID, rg0);
"""
# (old, new) edits of render_train.cu per variant.
PATCHES = {
    "shipped": [],
    "no_mma": [("""      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 16; ++kk)
        wgmma_rs<HID, 1>(acc, a[s * (kSliceK / 16) + kk],
                         desc128(slot + kk * 2048, kSliceK * 128), s + kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
""", "      (void)slot;\n")],
    "no_ring": [("""      if (tid == 0 && q + kRingStages - 2 < q_total) load_slice(q + kRingStages - 2);
      mbar_wait(full0 + 8 * (q % kRingStages), (q / kRingStages) & 1);
""", "")],
    "no_rows": [(lam + nxt, lam + "    return;\n" + nxt)
                for lam, nxt in _ROW_LAMBDAS],
    "no_epi": [("          col_sums(cs, lane, cpw + 8 * j0);\n" + _SUMS_TAIL,
                _SUMS_TAIL)],
    "splits24": [("constexpr int kMaxSplits = 48;",
                  "constexpr int kMaxSplits = 24;")],
    "splits32": [("constexpr int kMaxSplits = 48;",
                  "constexpr int kMaxSplits = 32;")]}
LAUNCHES = {"train_bwd_kernel": "trunk_bwd", "wgrad_gemm_kernel": "gemm",
            "reduce_parts_kernel": "reduce"}


def build_variants(patches=None, out_name="train_bwd_probe",
                   src="render_train.cu",
                   entries=("nm_render_train_forward", "nm_render_train_backward",
                            "nm_render_train_workspace")):
    """One ``nvcc`` a variant, all started together -> {variant: library}.
    An edit is (old, new) in ``src`` or (file, old, new) in another file of
    ``csrc/``; each variant's edited files go to a directory of their own,
    which its includes search first.  ``entries``: the C entries to bind."""
    out_root = ROOT / "build" / out_name
    jobs = {}
    for name, edits in (PATCHES if patches is None else patches).items():
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        texts = {}
        for edit in edits:
            fname, old, new = edit if len(edit) == 3 else (src, *edit)
            text = texts.get(fname) or (kernels.CSRC / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit does not match once: {old!r}")
            texts[fname] = text.replace(old, new)
        texts.setdefault(src, (kernels.CSRC / src).read_text())
        for fname, text in texts.items():
            (out_dir / fname).write_text(text)
        so = out_dir / Path(src).with_suffix(".so").name
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}",
               "-shared", "-o", str(so), str(out_dir / src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        (so.parent / "build.log").write_text(log)   # -Xptxas -v
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in entries:
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def profile_ms(call, launches, reps=3):
    """Device ms of each launch (``launches``: kernel name -> label) per
    call, mean over ``reps`` calls under ``torch.profiler``."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    ms = dict.fromkeys(launches.values(), 0.0)
    for e in prof.key_averages():
        for key, label in launches.items():
            if key in e.key:
                ms[label] += e.self_device_time_total / 1e3 / reps
    ms["total"] = sum(ms.values())
    return ms


def main():
    smi = chip_smoke.phase_environment()
    dev = torch.device("cuda", 0)
    libs = build_variants()
    renderer = chip_smoke.load_room_renderer(dev)
    spec, rays, z, noise, target = chip_smoke.train_inputs(renderer, dev)
    packed = rtk.pack_train(spec.mlp)
    with torch.no_grad():
        rgb, w, stash = rtk.kernel_forward(spec, rays, z, noise, packed,
                                           stash=True)
    g_rgb, g_w = chip_smoke.train_cotangents(z, rgb, w, target)
    args = rtk._kernel_args(spec, rays, z, noise, packed)
    cfg = spec.mlp.cfg
    n, S = z.shape[0], z.shape[1] - 1
    _, n_grad, n_mat = rtk._sizes(cfg, n, S)
    P = rtk.backward_layout(cfg, n, S).vec_len
    work = torch.empty(n_grad, dtype=torch.uint8, device=dev)
    # Zeroed: the matrix block is sized for the widest layer layout, and
    # its tail past the products is never written.
    outs = [torch.zeros(n_mat + P, device=dev) for _ in range(2)]

    def run(lib, out, name):
        err = lib.nm_render_train_backward(
            *args, g_rgb.data_ptr(), g_w.data_ptr(), stash.data_ptr(),
            work.data_ptr(), out.data_ptr(), out[n_mat:].data_ptr(), None,
            kernels.stream_ptr(dev))
        kernels.check(err, f"render_train_bwd ({name})")

    run(kernels.library(), outs[0], "package")
    print(smi, flush=True)
    for name, lib in libs.items():
        run(lib, outs[1], name)
        torch.cuda.synchronize()
        if name == "shipped":
            assert torch.equal(outs[0], outs[1]), "shipped build != package"
        ms = profile_ms(lambda: run(lib, outs[1], name), LAUNCHES)
        print(json.dumps({"variant": name,
                          **{k: round(v, 4) for k, v in ms.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
