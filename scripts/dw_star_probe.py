"""What the StarReLU + 7x7 depthwise forward (kernel 7) and dgrad (kernel 8)
are made of, on one NVIDIA GPU.

    python3 scripts/dw_star_probe.py [--parent-source FILE]

Builds ``nerfmatch_tpu_torch/csrc/sepconv.cu`` alone once per variant
below, each an edited copy of the source (``PATCHES``, each edit matched
exactly once), into ``build/dw_star_probe/<variant>/``, one ``nvcc`` a
variant, all started together:

* ``shipped``: as the package builds it;
* ``copy_only``: no FMAs (the tiles are staged, activated and stored; the
  outputs are cbias or 0);
* ``no_act``: the forward skips its StarReLU pass over the staged halo;
* ``one_stage``: a ring of one stage (no double buffering: a tile's load
  starts only when the tile before it is done);
* ``load_only``: ``copy_only`` that stores no output (the dgrad still
  sums ds and db);
* ``reg_store``: the forward stores its outputs from registers (masked at
  the ragged edge, as the dgrad does) instead of one TMA store a tile from
  an output buffer;
* ``group_outer``: the blocks walk the tiles with the channel group
  outermost (the blocks at work at one time read 128 bytes of each
  pixel's row);
* ``full_grid``: the forward's grid not cut to a multiple of the channel
  groups (a block on every SM, as the dgrad's: blocks change channel group,
  and reload their taps, from tile to tile);
* ``cut_grid``: the dgrad's grid cut too (a block keeps its channel group);
* ``parent``: with ``--parent-source FILE``, an earlier ``sepconv.cu``
  (the one-thread-a-channel design, whose forward and dgrad take [s, b] as
  one pointer and whose dgrad writes ``(C / 128) ceil(H / 8) ceil(W / 4)
  B`` partials), copied and built like the others.

Then it times each build's ``nm_dw_star_forward`` and ``nm_dw_star_dgrad``
(CUDA events, mean of 20 launches after a warm-up) at the c2f trunk's
stage-0 and stage-1 shapes at batch 1 and 2, the variants in order and
again in reverse (parent, shipped, ..., shipped, parent), and prints one
JSON line per shape after the card's name and power limit: ms per variant,
both rounds; the last line gives the host microseconds per call of the
package's two wrappers at a small shape.  The shipped build's outputs must
equal the package's bit for bit; the probe builds compute something else
and are only timed.  Compare within one run only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import sepconv_kernel as sk  # noqa: E402

_CALL = "    patch_taps(halo + (py * kHaloW + px) * kTileC + lane, taps, acc);\n"
_ZERO = ("    for (auto& row : acc)\n"
         "      for (float& a : row) a = 0.f;\n")
_ACT = "      activate(halo, y0, x0, H, W, s, b_act);\n"
_STORE_Y = ("      if (!kDgrad) tma_store_4d(&out_map, sm0 + M::kOut, "
            "grp * kTileC, x0, y0, b);\n")
_STORE_DX = "        o[off] = 2.f * s * rx * d;\n"
_STAGES = "constexpr int kStages = 2;"
_TMA_SLOT = ("        if (!kDgrad) {   // TMA writes nothing outside the array\n"
             "          slot = acc[oy][ox] + cb;\n"
             "          continue;\n"
             "        }\n")
_DX = "        const float rx = fmaxf(slot, 0.f), d = acc[oy][ox];\n"
_REG_Y = ("        if (!kDgrad) {\n"
          "          o[off] = acc[oy][ox] + cb;\n"
          "          continue;\n"
          "        }\n")
_CUT = "  if (!kDgrad && sms > tl.groups) sms -= sms % tl.groups;\n"
# (old, new) edits of sepconv.cu per variant.
PATCHES = {
    "shipped": [],
    "copy_only": [(_CALL, _ZERO)],
    "no_act": [(_ACT, "")],
    "one_stage": [(_STAGES, _STAGES.replace("2", "1"))],
    "load_only": [(_CALL, _ZERO), (_STORE_Y, ""), (_STORE_DX, "")],
    "reg_store": [(_TMA_SLOT, ""), (_DX, _REG_Y + _DX), (_STORE_Y, "")],
    "group_outer": [("    const int grp = t % groups, r = t / groups;\n",
                     "    const int grp = t / (count / groups), "
                     "r = t % (count / groups);\n")],
    "full_grid": [(_CUT, "")],
    "cut_grid": [(_CUT, _CUT.replace("!kDgrad && ", ""))],
}
# The earlier design's entries: forward x, w, cbias, sb, y, B, H, W, C, K,
# stream; dgrad x, g, w, sb, dx, part, B, H, W, C, K, stream.
PARENT = {"nm_dw_star_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
          + [ctypes.c_void_p],
          "nm_dw_star_dgrad": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
          + [ctypes.c_void_p]}
SHAPES = {"stage 0, B=2": (2, 240, 240, 256), "stage 0, B=1": (1, 240, 240, 256),
          "stage 1, B=2": (2, 60, 60, 512), "stage 1, B=1": (1, 60, 60, 512)}
ENTRIES = ("nm_dw_star_forward", "nm_dw_star_dgrad", "nm_dw_star_dgrad_parts")


def build_variants(parent_source=None):
    """-> {variant: library}, each built into this checkout's build/."""
    out_root = ROOT / "build" / "dw_star_probe"
    sources = {}
    for name, edits in PATCHES.items():
        text = (kernels.CSRC / "sepconv.cu").read_text()
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
        (out_dir / "sepconv.cu").write_text(text)
        so = out_dir / "sepconv.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", "-shared",
               "-o", str(so), str(out_dir / "sepconv.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        (so.parent / "build.log").write_text(log)   # -Xptxas -v
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ENTRIES:
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = (PARENT if name == "parent" else
                                             kernels._SIGNATURES)[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def parts(lib, B, H, W, C):
    """Rows of [ds, db] partials this build's dgrad writes."""
    if not hasattr(lib, "nm_dw_star_dgrad_parts"):   # the parent's grid
        return (C // 128) * (-(-H // 8)) * (-(-W // 4)) * B
    n = ctypes.c_int(0)
    kernels.check(lib.nm_dw_star_dgrad_parts(B, H, W, C, ctypes.byref(n)),
                  "dw_star_dgrad_parts")
    return n.value


def host_us(dev, reps=200):
    """Host microseconds per call of the package's wrappers at (1, 16, 16,
    128), where the card waits on the host: what a wrapper costs beside its
    kernel."""
    x = torch.randn(1, 16, 16, 128, device=dev)
    w = torch.randn(7, 7, 128, device=dev)
    s, b = torch.tensor(0.9, device=dev), torch.tensor(-0.4, device=dev)
    calls = {"dw_star_fwd": lambda: sk.dw_star_fwd(x, w, w[0, 0], s, b),
             "dw_star_dgrad": lambda: sk.dw_star_dgrad(x, w, s, x)}
    out = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        out[name] = round((time.perf_counter() - t0) / reps * 1e6, 1)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent-source", metavar="FILE",
                   help="an earlier sepconv.cu to build and time beside")
    args = p.parse_args()
    dev = torch.device("cuda", 0)
    import chip_smoke

    smi = chip_smoke.phase_environment()
    libs = build_variants(args.parent_source)
    order = (["parent"] if "parent" in libs else []) + list(PATCHES)
    print(smi, flush=True)
    g = torch.Generator(dev).manual_seed(2)
    for label, shape in SHAPES.items():
        B, H, W, C = shape
        x = torch.randn(shape, device=dev, generator=g)
        w = torch.randn(7, 7, C, device=dev, generator=g) * 0.1
        cb = torch.randn(C, device=dev, generator=g)
        # [s, b] for the forward; the dgrad reads s (the parent's [s, 0]).
        sb = torch.tensor([0.8944, -0.4472], device=dev)
        sb0 = torch.tensor([0.8944, 0.0], device=dev)
        up = torch.randn(shape, device=dev, generator=g)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        part = torch.empty(max(parts(lib, *shape) for lib in libs.values()), 2,
                           device=dev)
        stream = kernels.stream_ptr(dev)

        s_ptr = sb.data_ptr()
        b_ptr = s_ptr + sb.element_size()

        def fwd(lib):
            scalars = (s_ptr,) if lib is libs.get("parent") else (s_ptr, b_ptr)
            kernels.check(lib.nm_dw_star_forward(
                x.data_ptr(), w.data_ptr(), cb.data_ptr(), *scalars,
                y.data_ptr(), B, H, W, C, 7, stream), "dw_star_fwd")

        def dgrad(lib):
            grid = () if lib is libs.get("parent") else (parts(lib, *shape),)
            kernels.check(lib.nm_dw_star_dgrad(
                x.data_ptr(), up.data_ptr(), w.data_ptr(), sb0.data_ptr(),
                dx.data_ptr(), part.data_ptr(), *grid, B, H, W, C, 7, stream),
                "dw_star_dgrad")

        shipped = libs["shipped"]
        fwd(shipped)
        dgrad(shipped)
        n = parts(shipped, *shape)
        ds_db = part[:n].sum(0)
        ref_dx, ref_ds, ref_db = sk.dw_star_dgrad(x, w, sb[0], up)
        assert torch.equal(y, sk.dw_star_fwd(x, w, cb, sb[0], sb[1])), \
            "shipped forward != package"
        assert (torch.equal(dx, ref_dx) and torch.equal(ds_db[0], ref_ds)
                and torch.equal(ds_db[1], ref_db)), "shipped dgrad != package"
        row = {"shape": label}
        for names in (order, order[::-1]):
            for name in names:
                lib = libs[name]
                f = chip_smoke.cuda_ms(lambda: fwd(lib), 20)
                d = chip_smoke.cuda_ms(lambda: dgrad(lib), 20)
                row.setdefault(name, {"fwd_ms": [], "dgrad_ms": []})
                row[name]["fwd_ms"].append(round(f, 4))
                row[name]["dgrad_ms"].append(round(d, 4))
        print(json.dumps(row), flush=True)
        del x, up, y, dx, part
    print(json.dumps({"host_us_per_call": host_us(dev)}), flush=True)


if __name__ == "__main__":
    main()
