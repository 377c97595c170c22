"""What the bf16 attention kernels' time is made of, on one NVIDIA GPU.

    python3 scripts/attention_probe.py [--parent-source FILE]

Builds ``nerfmatch_tpu_torch/csrc/attention.cu`` three times (as shipped;
with ``-DNM_ATTN_PROBE_NO_EX2``, a multiply-add in place of every ex2; with
``-DNM_ATTN_PROBE_NO_LOADS``, the tile loads left out of the loops), and
``--parent-source`` FILE (an earlier ``attention.cu`` with its headers
beside it, e.g. ``git archive <commit> nerfmatch_tpu_torch/csrc`` unpacked
into a gitignored directory) as a fourth, one ``nvcc`` each, all started
together, into ``build/attention_probe/``.  Then it times, at the
matcher's shapes (H=8, L=S=3600, D=32; B=1 and B=2), on operands already
cast to bf16 and with no host work between launches:

* the forward kernel and the backward (prologue + dK/dV + dQ, ``out`` and
  ``lse`` handed in) of each build;
* ``scaled_dot_product_attention`` and its autograd backward on the same
  operands.

The shipped build's outputs are checked against the wrappers'; the probe
builds compute something else and are only timed; the parent's outputs are
compared with the shipped build's (``parent/same``: bit for bit).  The
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import attention_kernel as ak  # noqa: E402

VARIANTS = {"shipped": [], "no_ex2": ["-DNM_ATTN_PROBE_NO_EX2"],
            "no_loads": ["-DNM_ATTN_PROBE_NO_LOADS"]}


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
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels._SIGNATURES.items():
            if fn.startswith("nm_attention"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
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
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_probe: needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants(args.parent_source)
    stream = torch.cuda.current_stream().cuda_stream
    L = S = 3600
    H, D = 8, 32
    for B in (1, 2):
        g = torch.Generator(dev).manual_seed(0)
        q, k, v = (torch.randn(B, L, H, D, device=dev, generator=g)
                   for _ in range(3))
        q, k, v = ak._operands((q / np.sqrt(D), k, v), True)
        up = torch.randn(B, L, H, D, device=dev, generator=g)
        out = torch.empty(B, L, H, D, device=dev)
        lse = torch.empty(B * H, L, device=dev)
        dq, dk, dv = (torch.empty_like(out) for _ in range(3))
        g_cast = torch.empty_like(up, dtype=torch.bfloat16)
        stats = torch.empty(2, B * H, L, device=dev)
        res, runs = {"B": B}, {}
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
            runs[name] = (fwd, bwd)
        # The shipped and parent builds in turns: parent, shipped, shipped,
        # parent.
        turns = (["parent", "shipped", "shipped", "parent"] if "parent" in runs
                 else ["shipped"])
        for name in [n for n in runs if n not in turns] + turns:
            for part, fn in zip(("fwd", "bwd"), runs[name]):
                res.setdefault(f"{name}/{part}_turns", []).append(
                    round(cuda_ms(fn), 4))
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
        print(json.dumps({k_: (round(v_, 4) if isinstance(v_, float) else v_)
                          for k_, v_ in res.items()}), flush=True)


if __name__ == "__main__":
    main()
