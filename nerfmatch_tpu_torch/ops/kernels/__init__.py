"""Build and load the hand-written CUDA kernels (``nerfmatch_tpu_torch/csrc``).

All ``csrc/*.cu`` files compile with one ``nvcc`` call into a shared library
with a plain C interface, loaded through ``ctypes``.  The build happens at
the first kernel launch on a CUDA device, never at import, so the package
imports on hosts without ``nvcc`` or a GPU.  The library is cached under
``build/kernels/<hash>/`` next to the package, keyed by a hash of the
sources and the compiler flags.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if that is not 0.  Each kernel wrapper counts its
launches in :data:`LAUNCHES` (one per launch, nowhere else), so a caller
can show that a run really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts by kernel name; incremented by each wrapper where it launches.
LAUNCHES = {"render_coarse": 0, "render_fine": 0, "resample": 0,
            "attention": 0, "render_train_fwd": 0, "render_train_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: (name, argtypes).  Every entry returns cudaError_t as int.
_SIGNATURES = {
    # params (host array of device pointers), n_rays, hid, layer_num,
    # feat_layer, num_freqs, dirs_freqs, samples, var_scale, log_eps,
    # white_bg, fine, out pointers x6, stream
    "nm_render_forward": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P],
    # bins, weights, u (or null), out, n_rays, n_bins, padding, stream
    "nm_resample_forward": [_P, _P, _P, _P, _I, _I, _F, _P],
    # params, n_rays, hid, layer_num, num_freqs, dirs_freqs, samples,
    # var_scale, white_bg, out_rgb, out_w, stream
    "nm_render_train_forward": [_P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P,
                                _P],
    # n_rays, hid, layer_num, samples, out workspace bytes, out matrix block
    "nm_render_train_workspace": [_I, _I, _I, _I, _P, _P],
    # params, n_rays, hid, layer_num, num_freqs, dirs_freqs, samples,
    # var_scale, white_bg, g_rgb, g_w, workspace, grad_mat, grad_vec, stream
    "nm_render_train_backward": [_P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P,
                                 _P, _P, _P, _P],
    # q, k, v, out, B, L, S, H, D, bf16, stream
    "nm_attention_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_LIB = None
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (if not cached) and return the library path."""
    srcs, digest = _sources()
    out_dir = BUILD_ROOT / digest
    lib = out_dir / "libnerfmatch_kernels.so"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib.tmp{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                       + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=secs, cached=False,
                      log=proc.stderr)
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_tensors(name: str, *tensors) -> None:
    """Kernel inputs must be contiguous float tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
