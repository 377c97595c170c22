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

each timed with CUDA events over ``--reps`` calls after a warm-up, the two
builds in turns (parent, package, package, parent) for ``--rounds`` rounds.
The two builds' outputs must be equal bit for bit (the stash sizes come
from the package's ``nm_render_train_workspace``: they are the same at
these shapes).  Prints each build's ``ptxas`` lines of the HID-256
instantiations, then one JSON line with the mean times (ms), the ratio
package / parent, the outputs' agreement, the build seconds, and the card's
name and power limit.  Compare within one run only.
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


class _WithPackageSizes:
    """An earlier library whose workspace sizes come from the package's
    (its ``nm_render_train_workspace`` may take other arguments)."""

    def __init__(self, lib, package):
        self.lib, self.package = lib, package

    def __getattr__(self, name):
        return getattr(self.package if name == "nm_render_train_workspace"
                       else self.lib, name)


def ptxas_256(log):
    """The ptxas lines (registers, spills) of the HID-256 render and train
    kernels in an nvcc log."""
    name, out = "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "ILi256E" in name and ("Used" in line or "spill" in line):
            kern = re.search(r"(render_eval_kernel|train_fwd_kernel|"
                             r"train_bwd_kernel)ILi256E(\w*?)E", name)
            if kern:
                flags = re.findall(r"Lb(\d)", kern.group(2))
                out.append(f"{kern.group(1)}<256{''.join(', ' + f for f in flags)}>: "
                           + line.strip().replace("ptxas info    : ", ""))
    return out


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
    libs = {"parent": _WithPackageSizes(kernels.load(parent_so, PARENT_ENTRIES),
                                        package),
            "package": package}
    for name, so in (("package", kernels.build()), ("parent", parent_so)):
        for line in ptxas_256((Path(so).parent / "build.log").read_text()):
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
        "same_bits": same, "build_s": {"package": round(package_s, 1),
                                       "parent": round(parent_s, 1)}}),
          flush=True)
    assert all(same.values()), same


if __name__ == "__main__":
    main()
