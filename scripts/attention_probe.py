"""What the attention kernels' time is made of, on one NVIDIA GPU.

    python3 scripts/attention_probe.py [--parent-source FILE]
        [--head-dims 32,...] [--f32]

Builds ``nerfmatch_tpu_torch/csrc/attention.cu`` three times (as shipped;
with ``-DNM_ATTN_PROBE_NO_EX2``, a multiply-add in place of every ex2; with
``-DNM_ATTN_PROBE_NO_LOADS``, the tile loads left out of the loops), and
``--parent-source`` FILE (an earlier ``attention.cu`` with its headers
beside it, e.g. ``git archive <commit> nerfmatch_tpu_torch/csrc`` unpacked
into a gitignored directory) as a fourth, one ``nvcc`` each, all started
together, into ``build/attention_probe/``.  Then it times, at the
matcher's shapes (H=8, L=S=3600, D=32 or each of ``--head-dims``; B=1 and
B=2), on operands already cast to bf16 and with no host work between
launches:

* the forward kernel and the backward (prologue + dK/dV + dQ, ``out`` and
  ``lse`` handed in) of each build;
* ``scaled_dot_product_attention`` and its autograd backward on the same
  operands;
* with ``--f32``, the f32 mode's forward and backward (f32 operands, the
  split launch included) of the shipped and parent builds in the same
  turns (``f32_*``; the shipped build's outputs against the wrappers'),
  SDPA on f32 operands, and the device time of each of the shipped f32
  mode's launches (``f32_launch_ms``, ``torch.profiler``, a call's mean).

The shipped build's outputs are checked against the wrappers'; the probe
builds compute something else and are only timed; the parent's outputs are
compared with the shipped build's (``parent/same``: bit for bit), and the
bf16 kernels' ptxas lines (registers, spills) of the two builds
(``same_ptxas``, printed first with the lines that differ).  The
shipped and parent builds are timed in turns (parent, shipped, shipped,
parent: ``*_ms`` the mean of both turns, ``*_turns`` each).  One JSON line
per batch size, after the card's name and power limit; CUDA events, mean
of 30 back-to-back launches after warm-up.  Compare within one run only:
two runs may land on two cards.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak  # noqa: E402

VARIANTS = {"shipped": [], "no_ex2": ["-DNM_ATTN_PROBE_NO_EX2"],
            "no_loads": ["-DNM_ATTN_PROBE_NO_LOADS"]}


BF16_KERNELS = ("attention_bf16_kernel", "attn_bwd_dkdv_bf16",
                "attn_bwd_dq_bf16", "attn_bwd_prep", "attention_cast_bf16")


def bf16_ptxas(log):
    """{mangled kernel name: its ptxas lines} of the bf16 mode's kernels."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name if any(k in name for k in BF16_KERNELS) else None
        elif name and ("Used" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def build_variants(parent_source=None):
    out_dir = ROOT / "build" / "attention_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = str(kernels.CSRC / "attention.cu")
    builds = {name: (shipped, defs) for name, defs in VARIANTS.items()}
    if parent_source is not None:
        builds["parent"] = (str(parent_source), [])
    jobs = {}
    for name, (src, defs) in builds.items():
        so = out_dir / f"attention_{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defs, "-shared", "-o",
               str(so), src]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        logs[name] = log
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES.items():
            if fn.startswith("nm_attention"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    if "parent" in logs:
        # The symbols carry the source's path hash: compare the lines in
        # order of the kernels' names without it.
        key = lambda n: n.split("_attention_cu_", 1)[-1][8:]
        mine, theirs = (sorted((key(n), v) for n, v in bf16_ptxas(logs[b]).items())
                        for b in ("shipped", "parent"))
        diff = [(a, b) for a, b in zip(mine, theirs) if a != b]
        print(json.dumps({"same_ptxas": not diff and len(mine) == len(theirs),
                          "bf16_kernels": len(mine), "differ": diff[:8]}),
              flush=True)
    return libs


def cuda_ms(fn, reps=30):
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent-source", type=Path, default=None,
                   help="an earlier attention.cu, timed in turns with the "
                        "shipped one")
    p.add_argument("--head-dims", default="32",
                   help="comma-separated head_dims (default 32)")
    p.add_argument("--f32", action="store_true",
                   help="also time the f32 mode of each build")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_probe: needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants(args.parent_source)
    # The wrappers reach only the attention entries: they run on the
    # shipped build, not on a build of every csrc file.
    kernels._LIB = libs["shipped"]
    stream = torch.cuda.current_stream().cuda_stream
    L = S = 3600
    H = 8
    for D, B in ((D, B) for D in map(int, args.head_dims.split(","))
                 for B in (1, 2)):
        g = torch.Generator(dev).manual_seed(0)
        q32, k32, v32 = (torch.randn(B, L, H, D, device=dev, generator=g)
                         for _ in range(3))
        q32 = q32 / np.sqrt(D)
        q, k, v = ak._operands((q32, k32, v32), True)
        up = torch.randn(B, L, H, D, device=dev, generator=g)
        out = torch.empty(B, L, H, D, device=dev)
        lse = torch.empty(B * H, L, device=dev)
        dq, dk, dv = (torch.empty_like(out) for _ in range(3))
        g_cast = torch.empty_like(up, dtype=torch.bfloat16)
        ws = {m: torch.empty(ak.tf32_workspace_floats(B, L, S, H, D, m),
                             device=dev) for m in (False, True)}
        stats = torch.empty(2, B * H, L, device=dev)
        res, runs = {"B": B, "D": D}, {}
        for name, lib in libs.items():
            def fwd(lib=lib):
                return lib.nm_attention_forward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), 0, B, L, S, H, D, 1, stream)

            def bwd(lib=lib):
                return lib.nm_attention_backward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), up.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), g_cast.data_ptr(),
                    stats.data_ptr(), B, L, S, H, D, 1, stream)

            def fwd32(lib=lib, name=name):
                cast = 0 if name == "parent" else ws[False].data_ptr()
                return lib.nm_attention_forward(
                    q32.data_ptr(), k32.data_ptr(), v32.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), cast, B, L, S, H, D, 0,
                    stream)

            def bwd32(lib=lib, name=name):
                work = 0 if name == "parent" else ws[True].data_ptr()
                return lib.nm_attention_backward(
                    q32.data_ptr(), k32.data_ptr(), v32.data_ptr(),
                    up.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work,
                    stats.data_ptr(), B, L, S, H, D, 0, stream)

            if args.f32 and name in ("shipped", "parent"):
                assert fwd32() == 0 and bwd32() == 0
                torch.cuda.synchronize()
                if name == "shipped":
                    want, want_lse, _ = ak._forward_kernel(q32, k32, v32,
                                                           False, True)
                    grads = ak.attention_bwd(q32, k32, v32, up, False,
                                             out=want, lse=want_lse)
                    assert torch.equal(out, want) and torch.equal(lse, want_lse)
                    assert all(torch.equal(a, b)
                               for a, b in zip((dq, dk, dv), grads))
            assert fwd() == 0 and bwd() == 0
            torch.cuda.synchronize()
            if name in ("shipped", "parent"):
                want, want_lse, _ = ak._forward_kernel(q, k, v, True, True)
                grads = ak.attention_bwd(q, k, v, up, True, out=want,
                                         lse=want_lse)
                same = (torch.equal(out, want) and torch.equal(lse, want_lse)
                        and all(torch.equal(a, b)
                                for a, b in zip((dq, dk, dv), grads)))
                if name == "shipped":
                    assert same
                else:
                    res["parent/same"] = same
            runs[name] = (fwd, bwd, fwd32, bwd32)
        # The shipped and parent builds in turns: parent, shipped, shipped,
        # parent.
        turns = (["parent", "shipped", "shipped", "parent"] if "parent" in runs
                 else ["shipped"])
        parts = ("fwd", "bwd", "f32_fwd", "f32_bwd") if args.f32 else (
            "fwd", "bwd")
        for name in [n for n in runs if n not in turns] + turns:
            for part, fn in zip(parts, runs[name]):
                if part.startswith("f32") and name not in ("shipped", "parent"):
                    continue
                slow = part.startswith("f32") and name == "parent"
                res.setdefault(f"{name}/{part}_turns", []).append(
                    round(cuda_ms(fn, 3 if slow else 30), 4))
        for key in [k_ for k_ in res if k_.endswith("_turns")]:
            res[key.replace("_turns", "_ms")] = float(np.mean(res[key]))
        with torch.enable_grad():
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
            gb = up.transpose(1, 2).to(torch.bfloat16).contiguous()
            res["sdpa/bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                o, (qh, kh, vh), gb, retain_graph=True))
        with torch.no_grad():
            res["sdpa/fwd_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0))
        if args.f32:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    runs["shipped"][2]()
                    runs["shipped"][3]()
                torch.cuda.synchronize()
            res["f32_launch_ms"] = {
                e.key.replace("void (anonymous namespace)::", "").split("(")[0]:
                round(e.self_device_time_total / 1e3 / 3, 4)
                for e in prof.key_averages() if e.self_device_time_total > 0}
            with torch.enable_grad():
                qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                              for x in (q32, k32, v32))
                o = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
                gh = up.transpose(1, 2).contiguous()
                res["sdpa/f32_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    o, (qh, kh, vh), gh, retain_graph=True), 10)
            with torch.no_grad():
                res["sdpa/f32_fwd_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                           scale=1.0))
        print(json.dumps({k_: (round(v_, 4) if isinstance(v_, float) else v_)
                          for k_, v_ in res.items()}), flush=True)


if __name__ == "__main__":
    main()
