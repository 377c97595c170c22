"""Build and load the hand-written CUDA kernels (``nerfmatch_tpu_torch/csrc``).

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together (the build's wall time is that of the slowest file), and one more
links the objects into a shared library with a plain C interface, loaded
through ``ctypes``.  The build happens at
the first kernel launch on a CUDA device, never at import, so the package
imports on hosts without ``nvcc`` or a GPU.  The library is cached under
``build/kernels/<hash>/`` next to the package, keyed by a hash of the
sources and the compiler flags.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if that is not 0.  A wrapper makes its inputs' device
the current one around the C call: the entry points size their grids and
set kernel attributes for the current device, and launch on that device's
stream.  Each kernel wrapper counts its
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# Launch counts by kernel name; incremented by each wrapper where it launches.
LAUNCHES = {"render_coarse": 0, "render_fine": 0, "render_coarse_int8": 0,
            "render_fine_int8": 0, "render_fine_app": 0,
            "render_fine_int8_app": 0, "render_fine_max": 0,
            "render_fine_int8_max": 0, "render_fine_app_max": 0,
            "render_fine_int8_app_max": 0, "resample": 0,
            "attention": 0, "render_train_fwd": 0, "render_train_bwd": 0,
            "render_train_fwd_app": 0, "render_train_bwd_app": 0,
            "attention_bwd": 0, "dw_star_fwd": 0, "dw_star_dgrad": 0,
            "dw_star_wgrad": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: (name, argtypes).  Every entry returns cudaError_t as int.
_SIGNATURES = {
    # params, int8 params or null (host arrays of device pointers),
    # appearance rows or null, n_rays, hid, layer_num, feat_layer,
    # int8_from, num_freqs, dirs_freqs, samples, var_scale, log_eps,
    # white_bg, fine, feat_max, tile counter, tap scratch (or null), its
    # bytes, out pointers x6, tap debug output, int8 debug output, stream
    "nm_render_eval_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                               _F, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P],
    # hid, fine, n_rays -> the tile engine's scratch bytes (0 below hid
    # 512 and for the coarse stage at 512)
    "nm_render_eval_scratch": [_I, _I, _I],
    # hid, fine, int8, dirs_freqs -> dynamic shared memory bytes
    "nm_render_eval_smem": [_I, _I, _I, _I],
    # bins, weights, u (or null), out, n_rays, n_bins, padding, stream
    "nm_resample_forward": [_P, _P, _P, _P, _I, _I, _F, _P],
    # params, n_rays, hid, layer_num, num_freqs, dirs_freqs, samples,
    # var_scale, white_bg, out_rgb, out_w, stash (or null), the tile
    # engine's scratch (or null), its bytes, stream
    "nm_render_train_forward": [_P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P,
                                _P, _P, _I, _P],
    # hid, n_rays -> the tile engine's scratch bytes (0 below hid 1024)
    "nm_render_train_scratch": [_I, _I],
    # hid, layer_num, dirs_freqs, app_dim, forward (else the trunk
    # backward) -> dynamic shared memory bytes
    "nm_render_train_smem": [_I, _I, _I, _I, _I],
    # n_rays, hid, layer_num, samples, num_freqs, dirs_freqs, app_dim, out
    # stash bytes, out gradient workspace bytes, out matrix block
    "nm_render_train_workspace": [_I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # params, n_rays, hid, layer_num, num_freqs, dirs_freqs, samples,
    # var_scale, white_bg, g_rgb, g_w, stash, gradient workspace, grad_mat,
    # grad_vec, grad_app (or null), the tile engine's scratch (or null), its
    # bytes, stream
    "nm_render_train_backward": [_P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P,
                                 _P, _P, _P, _P, _P, _P, _I, _P],
    # q, k, v, out, lse (or null), bf16 workspace for f32 q, k, v (or
    # null), B, L, S, H, D, bf16, stream
    "nm_attention_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P],
    # q, k, v, g, out, lse, dq, dk, dv, bf16 workspace for g, stats, B, L, S,
    # H, D, bf16, stream
    "nm_attention_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _P],
    # x, w, cbias, s, b, y, B, H, W, C, K, stream
    "nm_dw_star_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # B, H, W, C, out number of [ds, db] partials
    "nm_dw_star_dgrad_parts": [_I, _I, _I, _I, _P],
    # x, g, w, s, dx, part, parts, B, H, W, C, K, stream
    "nm_dw_star_dgrad": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # B, H, W, C, out number of tap-sum partials rows
    "nm_dw_star_wgrad_parts": [_I, _I, _I, _I, _P],
    # x, g, s, b, dw, part, parts, B, H, W, C, K, stream
    "nm_dw_star_wgrad": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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


def _sources(src_dir: Path):
    srcs = sorted(src_dir.glob("*.cu"))
    headers = sorted(src_dir.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build(src_dir=CSRC, build_root=BUILD_ROOT) -> Path:
    """Compile ``src_dir/*.cu`` (the package's ``csrc`` by default; a probe
    may hand an earlier one) into ``build_root/<hash>/`` if not cached
    there, and return the library path."""
    srcs, digest = _sources(Path(src_dir))
    out_dir = Path(build_root) / digest
    lib = out_dir / "libnerfmatch_kernels.so"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Objects and the library are written under per-process names, and only
    # the finished library is renamed into place: two processes that build
    # at once never read each other's half-written files.
    pid = os.getpid()
    objs = [out_dir / f"{src.stem}.tmp{pid}.o" for src in srcs]
    tmp = out_dir / f"lib.tmp{pid}.so"
    t0 = time.perf_counter()
    jobs = []
    for src, obj in zip(srcs, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    (out_dir / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=secs, cached=False,
                      log="\n".join(logs))
    return lib


def load(path, entries=None):
    """The library at ``path`` with the C signatures of ``entries`` (all of
    :data:`_SIGNATURES` by default) bound."""
    lib = ctypes.CDLL(str(path))
    for name in entries or _SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        _LIB = load(build())
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_tensors(name: str, *tensors) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: inputs must be CUDA tensors, got one "
                             f"on {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
