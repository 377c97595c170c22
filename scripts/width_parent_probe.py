"""Kernels 1, 1b, 5 and 6 at the production MLP width against an earlier
build of them, on one NVIDIA GPU.

    python3 scripts/width_parent_probe.py --parent-source DIR [--rounds 2]

DIR: an earlier ``nerfmatch_tpu_torch/csrc`` (``git archive <commit>
nerfmatch_tpu_torch/csrc`` unpacked into a gitignored directory) whose C
entries ``nm_render_eval_forward``, ``nm_render_train_forward`` and
``nm_render_train_backward`` take the package's arguments.  The package's
kernels and DIR's build together (every ``*.cu`` of each in its own
``nvcc``, all started at once; DIR's into ``build/width_parent_probe/``).
Then, on the inputs of ``chip_smoke.py``'s phases 3, 3d and 3b (the room's
MLPs, 8 layers of 256, F = 15, Fd = 4, 9216 rays x 128 samples), it runs
through the package's wrappers with one build's library at a time:

* kernel 1's fine stage, bf16 trunk, eps 1e-4;
* kernel 1b's coarse stage, the serving default's int8 trunk, eps 1e-4;
* kernel 5, the training forward with its stash;
* kernel 6, the backward on that stash (its three launches);
* kernels 1 (fine, bf16) and 1b (coarse, int8) at MLP width 512
  (``chip_smoke.width_renderer(512)``: the room's config, seeded random
  weights), on the HID-512 engine (``render_eval_512.cuh``);

each timed with CUDA events over ``--reps`` calls after a warm-up, the two
builds in turns (parent, package, package, parent) for ``--rounds`` rounds.
The two builds' outputs must be equal bit for bit (the stash sizes come
from the package's ``nm_render_train_workspace``: they are the same at
these shapes).  Prints each build's ``ptxas`` lines of the HID-256 render
instantiations and of the train ones at HID 64-256, then one JSON line
with the mean times (ms), the ratio package / parent, the outputs'
agreement, whether the two builds' ptxas lines are the same (the HID-256
and HID-512 render instantiations and the train ones at HID 64-256; the
HID-512 render kernel's entry is named ``render_eval512_kernel<FINE, ..>``
in builds before the 1024 engine and ``render_eval_tile_kernel<512, FINE,
..>`` after: both read as ``render_eval_kernel<512, FINE, ..>``), the build
seconds, and the card's name and power limit.  Compare within one run
only.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nerfmatch_tpu_torch.nerf.model import eval_feat_layer  # noqa: E402
from nerfmatch_tpu_torch.ops import kernels  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import render_kernel as rk  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels import render_train_kernel as rtk  # noqa: E402
from nerfmatch_tpu_torch.ops.kernels.quant import (  # noqa: E402
    calibrate_act_scales, pack_kernel_int8)
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (  # noqa: E402
    resample_z_plain)

PARENT_ENTRIES = ("nm_render_eval_forward", "nm_render_train_forward",
                  "nm_render_train_backward")


# The eval entry's tap-scratch arguments (pointer, bytes), after the tile
# counter: an earlier build without the HID-512 engine takes neither.
EVAL_SCRATCH_ARGS = slice(17, 19)


def load_parent(path):
    """An earlier build's entries, the eval entry bound to its own
    signature (without the tap-scratch arguments where it has no
    ``nm_render_eval_scratch``)."""
    lib = kernels.load(path, PARENT_ENTRIES)
    try:
        lib.nm_render_eval_scratch
        old_eval = False
    except AttributeError:
        sig = list(kernels._SIGNATURES["nm_render_eval_forward"])
        del sig[EVAL_SCRATCH_ARGS]
        lib.nm_render_eval_forward.argtypes = sig
        old_eval = True
    return lib, old_eval


class _WithPackageSizes:
    """An earlier library whose workspace sizes come from the package's
    (its ``nm_render_train_workspace`` may take other arguments; the tap
    scratch, 0 bytes at these widths, too), its eval entry called without
    the tap-scratch arguments where it takes none."""

    def __init__(self, lib, package, old_eval):
        self.lib, self.package, self.old_eval = lib, package, old_eval

    def __getattr__(self, name):
        if name in ("nm_render_train_workspace", "nm_render_eval_scratch"):
            return getattr(self.package, name)
        fn = getattr(self.lib, name)
        if name == "nm_render_eval_forward" and self.old_eval:
            cut = EVAL_SCRATCH_ARGS
            return lambda *a: fn(*a[:cut.start], *a[cut.stop:])
        return fn


def ptxas_lines(log):
    """The ptxas lines (registers, spills) of the HID-256 and HID-512 render
    kernels and of the train kernels at every HID from 64 to 256 in an nvcc
    log, sorted by instantiation."""
    name, out = "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            # The HID-512 render kernel under either of its names.
            name = name.replace("render_eval512_kernelI",
                                "render_eval_kernelILi512E").replace(
                "render_eval_tile_kernelI", "render_eval_kernelI")
        elif "Used" in line or "spill" in line:
            kern = re.search(r"(render_eval_kernel|train_fwd_kernel|"
                             r"train_bwd_kernel)ILi(\d+)E(\w*?)E", name)
            if kern and (kern.group(2) in ("256", "512") if "eval" in kern.group(1)
                         else "train" in kern.group(1)):
                args = re.findall(r"L[bi](\d)", kern.group(3))
                out.append(f"{kern.group(1)}<{kern.group(2)}"
                           f"{''.join(', ' + a for a in args)}>: "
                           + line.strip().replace("ptxas info    : ", ""))
    return sorted(out)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent-source", required=True,
                   help="an earlier csrc directory")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    smi = chip_smoke.phase_environment()
    dev = torch.device("cuda", 0)

    built = {}
    t0 = time.perf_counter()
    parent_job = threading.Thread(target=lambda: built.update(parent=(
        kernels.build(args.parent_source, ROOT / "build" / "width_parent_probe"),
        time.perf_counter() - t0)))
    parent_job.start()
    package = kernels.library()
    package_s = time.perf_counter() - t0
    parent_job.join()
    parent_so, parent_s = built["parent"]
    parent, old_eval = load_parent(parent_so)
    libs = {"parent": _WithPackageSizes(parent, package, old_eval),
            "package": package}
    ptxas = {}
    for name, so in (("package", kernels.build()), ("parent", parent_so)):
        ptxas[name] = ptxas_lines((Path(so).parent / "build.log").read_text())
        for line in ptxas[name]:
            print(f"ptxas {name} {line}", flush=True)

    renderer = chip_smoke.load_room_renderer(dev)
    cmlp, fmlp = renderer.nerf_coarse, renderer.nerf_fine
    rays = chip_smoke.camera_rays(chip_smoke.room_c2w(0.4), 96, dev)
    t = torch.linspace(0.0, 1.0, 129, device=dev)
    z = (rays[:, 6:7] * (1.0 - t) + rays[:, 7:8] * t).contiguous()
    kw = dict(num_freqs=15, dirs_freqs=4, early_term_eps=1e-4)
    spec, trays, tz, noise, target = chip_smoke.train_inputs(renderer, dev)
    with torch.no_grad():
        scales = calibrate_act_scales(renderer, rays[:1024])
        q = pack_kernel_int8(cmlp, scales["coarse"], 0)
        pc8, pf = rk.pack_mlp(cmlp, q), rk.pack_mlp(fmlp)
        zf = resample_z_plain(z, rk.render_stage_plain(
            cmlp, rays, z, fine=False, **kw)["weights"]).contiguous()
        ptrain = rtk.pack_train(spec.mlp)
        rgb, w, stash = rtk.kernel_forward(spec, trays, tz, noise, ptrain,
                                           stash=True)
        r512 = chip_smoke.width_renderer(512, dev, seed=512)
        cmlp512, fmlp512 = r512.nerf_coarse, r512.nerf_fine
        q512 = pack_kernel_int8(cmlp512, calibrate_act_scales(
            r512, rays[:1024])["coarse"], 0)
        pc512, pf512 = rk.pack_mlp(cmlp512, q512), rk.pack_mlp(fmlp512)
        zf512 = resample_z_plain(z, rk.render_stage_plain(
            cmlp512, rays, z, fine=False, **kw)["weights"]).contiguous()
    g_rgb, g_w = chip_smoke.train_cotangents(tz, rgb, w, target)
    del rgb, w
    cases = {
        "kernel1_fine_bf16": lambda: rk.render_stage(
            fmlp, rays, zf, fine=True, packed=pf, **kw),
        "kernel1b_coarse_int8": lambda: rk.render_stage(
            cmlp, rays, z, fine=False, packed=pc8, int8=q, **kw),
        "kernel5_fwd_stash": lambda: rtk.kernel_forward(
            spec, trays, tz, noise, ptrain, stash=True)[:2],
        "kernel6_bwd": lambda: rtk.kernel_backward(
            spec, stash, trays, tz, noise, g_rgb, g_w, ptrain),
        "kernel1_fine_bf16_512": lambda: rk.render_stage(
            fmlp512, rays, zf512, fine=True, packed=pf512, **kw),
        "kernel1b_coarse_int8_512": lambda: rk.render_stage(
            cmlp512, rays, z, fine=False, packed=pc512, int8=q512, **kw),
    }
    assert eval_feat_layer(fmlp.cfg) == 3
    outs, times = {}, {n: {b: [] for b in libs} for n in cases}
    try:
        for r in range(args.rounds):
            for build in ("parent", "package", "package", "parent"):
                kernels._LIB = libs[build]
                with torch.no_grad():
                    for name, call in cases.items():
                        if r == 0 and name not in outs.get(build, {}):
                            out = call()
                            outs.setdefault(build, {})[name] = (
                                list(out.values()) if isinstance(out, dict)
                                else list(out))
                        times[name][build].append(chip_smoke.cuda_ms(call, args.reps))
    finally:
        kernels._LIB = package
    same = {n: all(torch.equal(a, b) for a, b in zip(outs["parent"][n],
                                                     outs["package"][n]))
            for n in cases}
    mean = {n: {b: sum(v) / len(v) for b, v in bt.items()} for n, bt in times.items()}
    print(json.dumps({
        "card": smi, "reps": args.reps, "rounds": args.rounds,
        "ms": {n: {b: round(v, 4) for b, v in m.items()} for n, m in mean.items()},
        "all_ms": {n: {b: [round(x, 4) for x in v] for b, v in bt.items()}
                   for n, bt in times.items()},
        "package_over_parent": {n: round(m["package"] / m["parent"], 4)
                                for n, m in mean.items()},
        "same_bits": same, "same_ptxas": ptxas["package"] == ptxas["parent"],
        "build_s": {"package": round(package_s, 1),
                                       "parent": round(parent_s, 1)}}),
          flush=True)
    assert all(same.values()), same


if __name__ == "__main__":
    main()
