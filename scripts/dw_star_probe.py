"""What the StarReLU + 7x7 depthwise forward (kernel 7), dgrad (kernel 8)
and weight gradient (kernel 9) are made of, on one NVIDIA GPU.

    python3 scripts/dw_star_probe.py [--parent-source FILE]

Builds ``nerfmatch_tpu_torch/csrc/sepconv.cu`` alone once per variant
below, each an edited copy of the source (``PATCHES``, each edit matched
exactly once), into ``build/dw_star_probe/<variant>/``, one ``nvcc`` a
variant, all started together:

* ``shipped``: as the package builds it;
* ``copy_only``: no FMAs (the tiles are staged, activated and stored; the
  outputs are cbias or 0; the wgrad's tap sums 0);
* ``no_act``: the forward and the wgrad skip their StarReLU pass over the
  staged halo;
* ``one_stage``: a ring of one stage (no double buffering: a tile's load
  starts only when the tile before it is done);
* ``load_only``: ``copy_only`` that stores no output (the dgrad still
  sums ds and db, the wgrad still writes its partials);
* ``reg_store``: the forward stores its outputs from registers (masked at
  the ragged edge, as the dgrad does) instead of one TMA store a tile from
  an output buffer;
* ``group_outer``: the blocks walk the tiles with the channel group
  outermost (the blocks at work at one time read 128 bytes of each
  pixel's row; the wgrad's blocks then change group within their walk);
* ``full_grid``: the forward's grid not cut to a multiple of the channel
  groups (a block on every SM, as the dgrad's: blocks change channel group,
  and reload their taps, from tile to tile);
* ``cut_grid``: the dgrad's grid cut too (a block keeps its channel group);
* ``no_sum``: the wgrad without its second launch (the sum of the
  partials rows per channel group);
* ``parent``: with ``--parent-source FILE``, an earlier ``sepconv.cu``
  whose forward and dgrad have the shipped entries and whose wgrad is the
  one-thread-a-channel kernel: it takes [s, b] as one pointer and writes a
  ``(B ceil(H / 32) ceil(W / 4), 49, C)`` partials buffer, summed here by
  ``part.sum(0)`` as its wrapper did (timed with the sum and without it).

Then it times each build's ``nm_dw_star_forward`` and ``nm_dw_star_dgrad``
at the c2f trunk's stage-0 and stage-1 shapes at batch 1 and 2, and
``nm_dw_star_wgrad`` at batch 2 (training), with CUDA events, mean of 20
launches after a warm-up; the variants in order and again in reverse
(parent, shipped, ..., shipped, parent).  It prints one JSON line per shape
after the card's name and power limit: ms per variant, both rounds; the
last line gives the host microseconds per call of the package's three
wrappers at a small shape.  The shipped build's outputs must equal the
package's bit for bit; the probe builds compute something else and are
only timed.  Stage 1's 29.5 MB of x and g fit in the 50 MB L2, so its
repeated launches read them warm.  Compare within one run only.
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
_WCALL = ("    patch_wgrad(halo + (py * kHaloW + px) * kTileC + lane,\n"
          "                halo + kHaloBytes / 4 + (py * kTileW + px) * kTileC "
          "+ lane, acc);\n")
_WACT = "    activate(halo, tt.y0, tt.x0, H, W, s, b);\n"
_WSUM = ("  wgrad_sum_kernel<<<dim3(tl.groups, kTaps * kTaps), kTileC, 0, "
         "stream>>>(\n      part, dw, tl.groups, grid / tl.groups, C);\n")
# (old, new) edits of sepconv.cu per variant.
PATCHES = {
    "shipped": [],
    "copy_only": [(_CALL, _ZERO), (_WCALL, "")],
    "no_act": [(_ACT, ""), (_WACT, "")],
    "one_stage": [(_STAGES, _STAGES.replace("2", "1"))],
    "load_only": [(_CALL, _ZERO), (_STORE_Y, ""), (_STORE_DX, ""),
                  (_WCALL, "")],
    "reg_store": [(_TMA_SLOT, ""), (_DX, _REG_Y + _DX), (_STORE_Y, "")],
    "group_outer": [("    const int grp = t % groups, r = t / groups;\n",
                     "    const int grp = t / (count / groups), "
                     "r = t % (count / groups);\n")],
    "full_grid": [(_CUT, "")],
    "cut_grid": [(_CUT, _CUT.replace("!kDgrad && ", ""))],
    "no_sum": [(_WSUM, "")],
}
# The earlier design's wgrad entry: x, g, sb, part, B, H, W, C, K, stream.
PARENT = {"nm_dw_star_wgrad": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
          + [ctypes.c_void_p]}
SHAPES = {"stage 0, B=2": (2, 240, 240, 256), "stage 0, B=1": (1, 240, 240, 256),
          "stage 1, B=2": (2, 60, 60, 512), "stage 1, B=1": (1, 60, 60, 512)}
ENTRIES = ("nm_dw_star_forward", "nm_dw_star_dgrad", "nm_dw_star_dgrad_parts",
           "nm_dw_star_wgrad", "nm_dw_star_wgrad_parts")


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
        sigs = dict(kernels._SIGNATURES, **(PARENT if name == "parent" else {}))
        for fn in ENTRIES:
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sigs[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def parts(lib, B, H, W, C, entry="nm_dw_star_dgrad_parts"):
    """Partials rows this build's dgrad (or with ``entry`` its wgrad)
    writes."""
    n = ctypes.c_int(0)
    kernels.check(getattr(lib, entry)(B, H, W, C, ctypes.byref(n)), entry)
    return n.value


def wgrad_part(lib, B, H, W, C, dev):
    """The partials buffer of this build's wgrad: (rows, 49, 32), or the
    earlier design's (regions, 49, C)."""
    if hasattr(lib, "nm_dw_star_wgrad_parts"):
        return torch.empty(parts(lib, B, H, W, C, "nm_dw_star_wgrad_parts"),
                           49, 32, device=dev)
    return torch.empty(B * (-(-H // 32)) * (-(-W // 4)), 49, C, device=dev)


def host_us(dev, reps=200):
    """Host microseconds per call of the package's wrappers at (1, 16, 16,
    128), where the card waits on the host: what a wrapper costs beside its
    kernel."""
    x = torch.randn(1, 16, 16, 128, device=dev)
    w = torch.randn(7, 7, 128, device=dev)
    s, b = torch.tensor(0.9, device=dev), torch.tensor(-0.4, device=dev)
    calls = {"dw_star_fwd": lambda: sk.dw_star_fwd(x, w, w[0, 0], s, b),
             "dw_star_dgrad": lambda: sk.dw_star_dgrad(x, w, s, x),
             "dw_star_wgrad": lambda: sk.dw_star_wgrad(x, s, b, x)}
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
        train = B == 2   # the serving batch takes no weight gradient
        x = torch.randn(shape, device=dev, generator=g)
        w = torch.randn(7, 7, C, device=dev, generator=g) * 0.1
        cb = torch.randn(C, device=dev, generator=g)
        s = torch.tensor(0.8944, device=dev)
        b = torch.tensor(-0.4472, device=dev)
        sb = torch.stack([s, b])   # the parent's wgrad takes [s, b]
        up = torch.randn(shape, device=dev, generator=g)
        y, dx = torch.empty_like(x), torch.empty_like(x)
        dw = torch.empty(7, 7, C, device=dev)
        grids = {name: parts(lib, *shape) for name, lib in libs.items()}
        part = torch.empty(max(grids.values()), 2, device=dev)
        wparts = {name: wgrad_part(lib, *shape, dev) if train else None
                  for name, lib in libs.items()}
        stream = kernels.stream_ptr(dev)

        def fwd(name):
            kernels.check(libs[name].nm_dw_star_forward(
                x.data_ptr(), w.data_ptr(), cb.data_ptr(), s.data_ptr(),
                b.data_ptr(), y.data_ptr(), B, H, W, C, 7, stream),
                "dw_star_fwd")

        def dgrad(name):
            kernels.check(libs[name].nm_dw_star_dgrad(
                x.data_ptr(), up.data_ptr(), w.data_ptr(), s.data_ptr(),
                dx.data_ptr(), part.data_ptr(), grids[name], B, H, W, C, 7,
                stream), "dw_star_dgrad")

        def wgrad(name, total=True):
            wp = wparts[name]
            if name == "parent":
                kernels.check(libs[name].nm_dw_star_wgrad(
                    x.data_ptr(), up.data_ptr(), sb.data_ptr(), wp.data_ptr(),
                    B, H, W, C, 7, stream), "dw_star_wgrad")
                if total:
                    torch.sum(wp, 0, out=dw.view(49, C))
                return
            kernels.check(libs[name].nm_dw_star_wgrad(
                x.data_ptr(), up.data_ptr(), s.data_ptr(), b.data_ptr(),
                dw.data_ptr(), wp.data_ptr(), wp.shape[0], B, H, W, C, 7,
                stream), "dw_star_wgrad")

        fwd("shipped")
        dgrad("shipped")
        ds_db = part[:grids["shipped"]].sum(0)
        ref_dx, ref_ds, ref_db = sk.dw_star_dgrad(x, w, s, up)
        assert torch.equal(y, sk.dw_star_fwd(x, w, cb, s, b)), \
            "shipped forward != package"
        assert (torch.equal(dx, ref_dx) and torch.equal(ds_db[0], ref_ds)
                and torch.equal(ds_db[1], ref_db)), "shipped dgrad != package"
        if train:
            wgrad("shipped")
            assert torch.equal(dw, sk.dw_star_wgrad(x, s, b, up)), \
                "shipped wgrad != package"
        row = {"shape": label}
        for names in (order, order[::-1]):
            for name in names:
                times = {"fwd_ms": chip_smoke.cuda_ms(lambda: fwd(name), 20),
                         "dgrad_ms": chip_smoke.cuda_ms(lambda: dgrad(name), 20)}
                if train:
                    times["wgrad_ms"] = chip_smoke.cuda_ms(
                        lambda: wgrad(name), 20)
                if train and name == "parent":
                    times["wgrad_nosum_ms"] = chip_smoke.cuda_ms(
                        lambda: wgrad(name, total=False), 20)
                for k, v in times.items():
                    row.setdefault(name, {}).setdefault(k, []).append(
                        round(v, 4))
        print(json.dumps(row), flush=True)
        del x, up, y, dx, part, wparts
    print(json.dumps({"host_us_per_call": host_us(dev)}), flush=True)


if __name__ == "__main__":
    main()
