"""What the inverse-CDF resample (kernel 2) is made of, on one NVIDIA GPU.

    python3 scripts/resample_probe.py [--parent-source FILE]

Builds ``nerfmatch_tpu_torch/csrc/resample.cu`` alone once per variant
below, each an edited copy of the source (``PATCHES``, each edit matched
exactly once), into ``build/resample_probe/<variant>/``, one ``nvcc`` a
variant, all started together:

* ``shipped``: as the package builds it;
* ``warp_per_ray``: 32 lanes a ray (one ray a warp, as the first design:
  9216 warps, more than the card holds at once);
* ``scalar_loads``: the weights by scalar loads, never float4;
* ``serial_cdf``: the ray's first lane walks the cdf in order, one IEEE
  division a bin, as the first design did (the lanes still blur, sum and
  search in parallel);
* ``loop_search``: the first design's binary search over nb slots, a loop
  that stops when its range is empty (lanes leave it at different steps);
* ``no_search``: no search (count = k + 1): the loads, the scan, the
  interpolation and the stores alone;
* ``fast_div``: ``__fdividef`` for the pdf and the interpolation (not the
  plain version's rounding);
* ``lanes_8``: 8 lanes a ray (four rays a warp);
* ``empty``: every block returns at once (the launch and the dispatch of
  2304 blocks); ``empty_192`` the same with 768 blocks of 192 threads;
* ``copy_only``: the loads of the weights, bins and u, and one store of
  each output (no blur, scan, search or interpolation);
* ``no_exit``: the output steps without an exit between them (lanes past
  the row redo its last bin), so that the compiler may interleave the
  lane's searches;
* ``rolled``, ``unroll_3``: the output loop not unrolled, or by 3;
* ``threads_128``, ``threads_256``: blocks of 128 or 256 threads (shipped:
  64, 2304 blocks, 17 or 18 an SM; at 256, 576 blocks, 4 or 5 an SM);
* ``parent``: with ``--parent-source FILE``, an earlier ``resample.cu``
  with the same C entry (e.g. ``git show <commit>:nerfmatch_tpu_torch/csrc/
  resample.cu``).

It times each build's ``nm_resample_forward`` alone on the coarse weights
of 9216 rays of the room fixture (``chip_smoke.py`` phase 3's inputs) with
the deterministic u and a stratified draw, with CUDA events around launches
queued behind a device sleep: ``warm_ms``, 50 launches back to back (the
14.2 MB of inputs and outputs stay in the 50 MB L2, as on the path, where
the coarse stage has just written the weights; ``chip_smoke.py``'s
``kernel_ms``), and ``cold_ms``, each of 20 launches alone after a 256 MB
write; the variants in order and again in reverse.  Then the parent's and
the shipped build's kernel records under ``torch.profiler``
(``profiler_ms``, no launch gaps; null where it lost them).  It
prints one JSON line per mode after the card's name and power limit, then
the wrapper's host microseconds a call.  The shipped build's outputs must
equal the package's bit for bit, the parent's must agree with them within
its own smoke tolerance, 1e-4 (its difference is printed); the other
variants compute something else and are only timed.  Compare within one
run only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import resample_z  # noqa: E402

_SCAN = (
    "  // pdf and the chunk's inclusive prefix, then the lanes' exclusive offset.\n"
    "  float c = 0.f;\n")
_SERIAL = (
    "#pragma unroll\n"
    "  for (int k = 0; k < kPer; ++k)\n"
    "    if (j0 + k < nw) cdf[j0 + k + 1] = blur[k];\n"
    "  __syncwarp();\n"
    "  if (sub == 0) {\n"
    "    float cs = 0.f;\n"
    "    cdf[0] = 0.f;\n"
    "    for (int i = 0; i < nw - 1; ++i) {\n"
    "      cs += (cdf[i + 1] + pad_w) / wsum;\n"
    "      cdf[i + 1] = fminf(1.f, cs);\n"
    "    }\n"
    "    cdf[nb - 1] = 1.f;\n"
    "  }\n"
    "  __syncwarp();\n"
    "  if (!live) return;\n"
    "  if (true) {} else {\n"
    "  float c = 0.f;\n")
_SCAN_END = "  if (sub == (nw - 1) / kPer) cdf[nb - 1] = 1.f;\n"
_SEARCH = "    const int cnt = min(count_le<kCap>(cdf, u, 0), nb);   // u = +inf\n"
_THREADS = "constexpr int kThreads = 64;"
_OUT = "  float* o = out + (size_t)ray * nb;\n"
_UNROLL = _OUT + "#pragma unroll\n"
_RAY = "  const int ray = blockIdx.x * kRays + slot;\n"
_STAGE = ("    if (sub + m * kRayLanes < nb) sb[sub + m * kRayLanes] = bv[m];\n")
_COPY = ("  if (live) {\n"
         "    float* oo = out + (size_t)ray * nb;\n"
         "#pragma unroll\n"
         "    for (int m = 0; m < kOut; ++m)\n"
         "      if (sub + m * kRayLanes < nb)\n"
         "        oo[sub + m * kRayLanes] = bv[m] + uv[m] + v[m % kPer];\n"
         "  }\n"
         "  if (n_rays > 0) return;\n")
# The first design's search: a loop that stops when the range is empty.
_LOOP = ("    int lo = 0, hi = nb;\n"
         "    while (lo < hi) {\n"
         "      const int mid = (lo + hi) >> 1;\n"
         "      if (cdf[mid] <= u) lo = mid + 1; else hi = mid;\n"
         "    }\n"
         "    const int cnt = lo;\n")
# (old, new) edits of resample.cu per variant.
PATCHES = {
    "shipped": [],
    "warp_per_ray": [("constexpr int kRayLanes = 16;",
                      "constexpr int kRayLanes = 32;")],
    "scalar_loads": [("  const bool vec = nw % 4 == 0 && "
                      "reinterpret_cast<size_t>(weights) % 16 == 0;\n",
                      "  const bool vec = false;\n")],
    "serial_cdf": [(_SCAN, _SERIAL), (_SCAN_END, _SCAN_END + "  }\n")],
    "loop_search": [(_SEARCH, _LOOP)],
    "no_search": [(_SEARCH, "    const int cnt = k + 1;\n")],
    "fast_div": [("(blur[k] + pad_w) / wsum", "__fdividef(blur[k] + pad_w, wsum)"),
                 ("(u - c0) / (c1 - c0)", "__fdividef(u - c0, c1 - c0)")],
    "lanes_8": [("constexpr int kRayLanes = 16;",
                 "constexpr int kRayLanes = 8;")],
    "empty": [(_RAY, "  if (n_rays > 0) return;\n" + _RAY)],
    "copy_only": [(_STAGE, _STAGE + _COPY)],
    "no_exit": [("    const int k = sub + m * kRayLanes;\n    if (k >= nb) break;\n",
                 "    const int k = min(sub + m * kRayLanes, nb - 1);\n"),
                ("    o[k] = __fadd_rn(", "    if (sub + m * kRayLanes < nb) o[k] = __fadd_rn(")],
    "rolled": [(_UNROLL, _OUT + "#pragma unroll 1\n")],
    "unroll_3": [(_UNROLL, _OUT + "#pragma unroll 3\n")],
    "empty_192": [(_RAY, "  if (n_rays > 0) return;\n" + _RAY),
                  (_THREADS, _THREADS.replace("64", "192"))],
    "threads_128": [(_THREADS, _THREADS.replace("64", "128"))],
    "threads_256": [(_THREADS, _THREADS.replace("64", "256"))],
}


def build_variants(parent_source=None):
    """-> {variant: library}, each built into this checkout's build/."""
    out_root = ROOT / "build" / "resample_probe"
    sources = {}
    for name, edits in PATCHES.items():
        text = (kernels.CSRC / "resample.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit does not match once: {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    if parent_source is not None:
        sources["parent"] = Path(parent_source).read_text()
    jobs = {}
    for name, text in sources.items():
        out_dir = out_root / name
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "resample.cu").write_text(text)
        so = out_dir / "resample.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
               str(out_dir / "resample.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        (so.parent / "build.log").write_text(log)   # -Xptxas -v
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.nm_resample_forward.argtypes = kernels._SIGNATURES["nm_resample_forward"]
        lib.nm_resample_forward.restype = ctypes.c_int
        libs[name] = lib
    return libs


def room_inputs(dev):
    """Phase 3's resample inputs: fenceposts and coarse weights (eps 1e-4)
    of 9216 rays of the room fixture."""
    import chip_smoke
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import render_stage_plain

    renderer = chip_smoke.load_room_renderer(dev)
    rays = chip_smoke.camera_rays(chip_smoke.room_c2w(0.4), 96, dev)
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    with torch.no_grad():
        w = render_stage_plain(renderer.nerf_coarse, rays, z, fine=False,
                               early_term_eps=1e-4, num_freqs=15,
                               dirs_freqs=4)["weights"].contiguous()
    return z, w


def cold_ms(launch, flush, reps=20):
    """Mean device time of ``launch`` after a 256 MB write has pushed its
    inputs out of the L2: an event pair around each launch alone, all
    queued behind a device sleep."""
    launch()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for start, end in ev:
        flush.fill_(0.0)
        start.record()
        launch()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def profiler_ms(launch, reps=50):
    """Mean duration of the resample kernel's own records over ``reps``
    launches (``torch.profiler``: no launch gaps), or None where the
    profiler kept fewer than half of them."""
    launch()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "resample_kernel" in e.key]
    runs = sum(e.count for e in ev)
    if runs < reps // 2:
        return None
    return round(sum(e.self_device_time_total for e in ev) / runs / 1e3, 5)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent-source", metavar="FILE",
                   help="an earlier resample.cu to build and time beside")
    args = p.parse_args()
    dev = torch.device("cuda", 0)
    import chip_smoke
    from nerfmatch_tpu_torch.nerf.sampling import stratified_u

    smi = chip_smoke.phase_environment()
    libs = build_variants(args.parent_source)
    order = (["parent"] if "parent" in libs else []) + list(PATCHES)
    print(smi, flush=True)
    z, w = room_inputs(dev)
    n, nb = z.shape
    u_strat = stratified_u(n, nb, torch.Generator(dev).manual_seed(0), dev)
    out = torch.empty_like(z)
    flush = torch.empty(64 * 2**20, device=dev)     # 256 MB, above the L2
    stream = kernels.stream_ptr(dev)
    for mode, u in (("deterministic", None), ("stratified", u_strat)):
        u_ptr = None if u is None else u.data_ptr()

        def run(name):
            kernels.check(libs[name].nm_resample_forward(
                z.data_ptr(), w.data_ptr(), u_ptr, out.data_ptr(), n, nb, 0.01,
                stream), "resample")

        run("shipped")
        assert torch.equal(out, resample_z(z, w, u=u)), "shipped != package"
        shipped = out.clone()
        if "parent" in libs:
            run("parent")
            parent_err = float((out - shipped).abs().max())
            # The parent's serial f32 cdf was held to the plain version at
            # 1e-4 (1.29e-5 read at these shapes).
            assert parent_err < 1e-4, f"parent differs by {parent_err}"
        row = {"mode": "u=" + mode, "rays": n, "bins": nb}
        if "parent" in libs:
            row["parent_max_abs_diff"] = parent_err
        for names in (order, order[::-1]):
            for name in names:
                times = {"warm_ms": chip_smoke.kernel_alone_ms(
                             lambda: run(name)),
                         "cold_ms": cold_ms(lambda: run(name), flush)}
                for k, v in times.items():
                    row.setdefault(name, {}).setdefault(k, []).append(
                        round(v, 5))
        for name in ("parent", "shipped"):
            if name in libs:
                row[name]["profiler_ms"] = profiler_ms(lambda: run(name))
        print(json.dumps(row), flush=True)
    host = {mode: round(chip_smoke.host_us(lambda: resample_z(z, w, u=u)), 1)
            for mode, u in (("deterministic", None), ("stratified", u_strat))}
    print(json.dumps({"wrapper_host_us_per_call": host}), flush=True)


if __name__ == "__main__":
    main()
