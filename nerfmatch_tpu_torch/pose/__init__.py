"""Host PnP + RANSAC pose solving (the port's copy of the JAX package's host
solver, ``nerfmatch_tpu/pose``; the C++ source ``csrc/pnp.cpp`` is the same).

``estimate_pose(pts2d, pts3d, K, ransac_thres, solver)`` -> ``(R, t,
inliers)`` world->camera, or ``None``:

* ``native`` (also the reference's ``colmap`` role): P3P + LO-RANSAC + LM in
  ``csrc/pnp.cpp``, compiled with g++ at first use into
  ``build/pnp/<hash>/`` (keyed by the source and the host CPU, since it is
  built with ``-march=native``) and loaded through ctypes;
* ``cv``: OpenCV ``solvePnPRansac`` (AP3P) + ``solvePnPRefineLM``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "pnp.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pnp"
_LIB = None
_D = ctypes.POINTER(ctypes.c_double)


def _digest() -> str:
    flags = ""
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        flags = next((line for line in cpuinfo.read_text().splitlines()
                      if line.startswith(("flags", "Features"))), "")
    h = hashlib.sha256(_SRC.read_bytes())
    h.update((platform.machine() + flags).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/pnp.cpp`` (if not cached) -> the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libpnp.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # A per-process name, renamed into place when done: processes that
    # build at once never load a half-written library.
    tmp = out_dir / f"libpnp.tmp{os.getpid()}.so"
    subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", str(_SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.pnp_ransac.restype = ctypes.c_int
        # pts2d, pts3d, n, K, thres, max_iters, confidence, seed,
        # refine_iters, R_out, t_out, inlier_mask, num_inliers
        lib.pnp_ransac.argtypes = [
            _D, _D, ctypes.c_int, _D, ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_uint64, ctypes.c_int, _D, _D,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    return _LIB


def _ptr(arr):
    return arr.ctypes.data_as(_D)


def estimate_pose_native(pts2d, pts3d, K, ransac_thres: float = 1.0,
                         max_iters: int = 2000, confidence: float = 0.9999,
                         seed: int = 0, refine_iters: int = 30):
    """C++ P3P + LO-RANSAC + LM -> (R, t, inlier indices) or None."""
    pts2d = np.ascontiguousarray(np.reshape(pts2d, (-1, 2)), np.float64)
    pts3d = np.ascontiguousarray(np.reshape(pts3d, (-1, 3)), np.float64)
    n = len(pts2d)
    if n < 4:
        return None
    K = np.ascontiguousarray(np.reshape(K, (3, 3)), np.float64)
    R, t = np.zeros((3, 3)), np.zeros(3)
    mask = np.zeros(n, np.uint8)
    n_inl = ctypes.c_int(0)
    ok = _library().pnp_ransac(
        _ptr(pts2d), _ptr(pts3d), n, _ptr(K), float(ransac_thres),
        int(max_iters), float(confidence), int(seed) or 0x12345678,
        int(refine_iters), _ptr(R), _ptr(t),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(n_inl))
    if not ok or np.isnan(t).any():
        return None
    return R, t, np.where(mask > 0)[0]


def estimate_pose_cv(pts2d, pts3d, K, ransac_thres: float = 1.0):
    """OpenCV AP3P RANSAC + LM refinement (the reference's 'cv' solver)."""
    import cv2

    pts2d = np.ascontiguousarray(pts2d, np.float32)
    pts3d = np.ascontiguousarray(pts3d, np.float32)
    K = np.ascontiguousarray(K, np.float32)
    if len(pts2d) < 4:
        return None
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(
        pts3d, pts2d, cameraMatrix=K, distCoeffs=None,
        reprojectionError=ransac_thres, flags=cv2.SOLVEPNP_AP3P)
    if not ok or inliers is None or np.isnan(tvec).any():
        return None
    inliers = inliers.ravel()
    rvec, tvec = cv2.solvePnPRefineLM(
        pts3d[inliers], pts2d[inliers], cameraMatrix=K, distCoeffs=None,
        rvec=rvec, tvec=tvec)
    return cv2.Rodrigues(rvec)[0], tvec.ravel(), inliers


def estimate_pose(pts2d, pts3d, K, ransac_thres: float = 1.0,
                  solver: str = "native", **kw):
    """solver: 'native' / 'colmap' (C++) or 'cv' (OpenCV) -> (R, t,
    inliers) world->camera, or None."""
    if solver in ("native", "colmap"):
        return estimate_pose_native(pts2d, pts3d, K, ransac_thres, **kw)
    if solver == "cv":
        if kw:
            raise ValueError(f"the cv solver takes no {sorted(kw)}")
        return estimate_pose_cv(pts2d, pts3d, K, ransac_thres)
    raise ValueError(f"unknown solver: {solver}")
