"""Where kernel 1b and its plain version disagree on an integer activation,
which of the two is right: both against an f64 reference, on one NVIDIA GPU.

    python3 scripts/int8_flip_witness.py [--seeds 10] [--rays 64] [--widths 256 512]

The int8 trunk's fine stage ('posttap': layers up to the descriptor tap
in bf16, the rest s8 x s8) and its control 'both' (every layer s8, no bf16
prefix) of the card tests' NeRF (8 layers, skip at 4, tap at 3, F = 15,
Fd = 4, ``--rays`` rays x 128 samples, eps 0), its weights drawn from seed
s and its rays from seed s + 1, s = 0 .. ``--seeds`` - 1; seed 0 is
``tests/test_torch_kernels_cuda.py``'s setup.  Each run holds three
versions of the last layer's s8 input ``hq`` and of the s8 encoding ``xq``
against each other:

* ``kernel``: ``render_stage(debug_q=True)``, the CUDA kernel;
* ``plain``: ``render_stage_plain(debug_q=True)``, f32 in torch's order;
* ``f64``: the same arithmetic (the same bf16 operand roundings, the same
  packed scales, the same half-even / truncating requantizations) with
  every product, sum and epilogue in f64, from an f64 encoding;
* ``f64prefix``: the plain version's arithmetic with only the bf16
  prefix's sums in f64 (its output rounded to f32 once): it differs from
  the plain version only where the prefix's f32 sums round.

A second check, at the posttap boundary itself (the tap layer's output
requantized to s8, which the kernel does not expose): the share of it on
which the f32 prefix and the f64 one round apart.  If the kernel's flips
against the plain version are f32 rounding at a requantization boundary,
the kernel and the plain version lie about equally far from f64, and the
boundary share grows with the width as the flips do.  Also checks that
this script's f32 copy of the arithmetic gives the plain version's ``hq``
bit for bit.  Prints one JSON line (per width and mode: each seed's
shares and largest steps), writes it to ``--out`` too, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nerfmatch_tpu_torch.config import dict2namespace  # noqa: E402
from nerfmatch_tpu_torch.models.layers import init_params_  # noqa: E402
from nerfmatch_tpu_torch.nerf.embedding import ipe_embedding  # noqa: E402
from nerfmatch_tpu_torch.nerf.model import eval_feat_layer  # noqa: E402
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer  # noqa: E402
from nerfmatch_tpu_torch.nerf.sampling import (frustum_moments,  # noqa: E402
                                               lift_gaussian)
from nerfmatch_tpu_torch.ops.kernels.quant import (  # noqa: E402
    calibrate_act_scales, pack_mlp_int8)
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (  # noqa: E402
    render_stage, render_stage_plain)

NUM_FREQS, DIRS_FREQS = 15, 4


def make_renderer(hid, dev, seed):
    """The card tests' NeRF (``renderer`` there), its weights from ``seed``."""
    nerf = {"method": "NeRF", "layer_num": 8, "hid_dim": hid,
            "output_dim": 4, "skips": [4], "num_pts": 128}
    cfg = dict2namespace({
        "render": {"use_viewdirs": True, "white_bg": False},
        "embedding": {"xyz_num_freqs": NUM_FREQS,
                      "dirs_num_freqs": DIRS_FREQS, "type": "mip"},
        "coarse_nerf": nerf, "fine_nerf": nerf})
    r = init_params_(NerfRenderer(cfg, stop_layer=3),
                     torch.Generator().manual_seed(seed))
    with torch.no_grad():
        r.nerf_fine.alpha_linear.bias += 3.0
    return r.to(dev).eval()


def make_rays(n, dev, seed):
    """The card tests' rays (``rays_z`` there) -> (rays (n, 12), z (n, 129))."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.05), np.full((n, 1), 1.4),
                           d, np.full((n, 1), 0.002)], -1).astype(np.float32)
    rays = torch.from_numpy(rays).to(dev)
    t = torch.linspace(0, 1, 129, device=dev)
    return rays, (rays[:, 6:7] * (1 - t) + rays[:, 7:8] * t).contiguous()


def encoding(rays, z):
    """The stage's integrated positional encoding in the dtype of the rays
    (``render_stage_plain``'s steps)."""
    o, d = rays[:, 0:3], rays[:, 8:11]
    t_mean, t_var, r_var = frustum_moments(z[:, :-1], z[:, 1:],
                                           rays[:, 11:12])
    mean, var = lift_gaussian(d, t_mean, t_var, r_var)
    return ipe_embedding(mean + o[:, None, :], var, NUM_FREQS)[0]


def trunk_q(mlp, enc, q, dtype, prefix_dtype=None):
    """``mlp_plain``'s trunk up to the last layer's s8 input in ``dtype``,
    its bf16 prefix in ``prefix_dtype`` (default ``dtype``; its output
    rounded to ``dtype``) -> (xq, hq of the last layer, the posttap
    boundary's s8 values or None)."""
    cast = lambda x: x.to(dtype)
    sat = lambda x: torch.clamp(x, -127.0, 127.0)
    cfg, E = mlp.cfg, enc.shape[-1]
    start, last = q["start"], cfg.layer_num - 1
    pd = prefix_dtype or dtype
    rnd = lambda x: x.to(torch.bfloat16).to(pd)
    h = enc_p = enc.to(pd)
    for i in range(start):
        x = torch.cat([enc_p, h], -1) if i > 0 and i - 1 in cfg.skips else h
        lin = mlp.pts_linears[i]
        h = torch.relu(F.linear(rnd(x), rnd(lin.weight), lin.bias.to(pd)))
    h, enc = cast(h), cast(enc)
    xq = sat(torch.round(enc * cast(q["qenc"][..., :E])))
    hq = boundary = sat(torch.round(h * cast(q["qh"]))) if start > 0 else None
    for i in range(start, last):
        inp = xq if i == 0 else hq
        y = (inp @ cast(q[f"w{i}q"][:inp.shape[-1]])) * cast(q[f"c{i}"])
        if f"w{i}sq" in q:
            y = y + (xq @ cast(q[f"w{i}sq"][:E])) * cast(q[f"c{i}s"])
        y = torch.clamp(y + cast(q[f"B{i}"]), min=0.5)
        hq = torch.trunc(torch.clamp(y, max=127.0))
    return xq, (xq if last == 0 else hq), boundary


def apart(a, b):
    """(share of elements apart, largest step)."""
    diff = (a.double() - b.double()).abs()
    return float((diff > 0).double().mean()), int(diff.max())


def one_run(hid, mode, seed, n, dev):
    r = make_renderer(hid, dev, seed)
    rays, z = make_rays(n, dev, seed + 1)
    mlp = r.nerf_fine
    tap = eval_feat_layer(mlp.cfg)
    scales = calibrate_act_scales(r, rays)["fine"]
    q = pack_mlp_int8(mlp, scales, 0 if mode == "both" else tap + 1, tap)
    kw = dict(fine=True, num_freqs=NUM_FREQS, dirs_freqs=DIRS_FREQS,
              int8=q, debug_q=True)
    with torch.no_grad():
        k = render_stage(mlp, rays, z, **kw)
        p = render_stage_plain(mlp, rays, z, **kw)
        xq32, hq32, b32 = trunk_q(mlp, encoding(rays, z), q, torch.float32)
        xq64, hq64, b64 = trunk_q(mlp, encoding(rays.double(), z.double()),
                                  q, torch.float64)
        _, hqm, bm = trunk_q(mlp, encoding(rays, z), q, torch.float32,
                             torch.float64)
    assert torch.equal(hq32.to(torch.int8), p["hq"]), "f32 copy != plain"
    assert torch.equal(xq32.to(torch.int8), p["xq"]), "f32 copy != plain"
    pairs = {"hq_kernel_plain": (k["hq"], p["hq"]),
             "hq_kernel_f64": (k["hq"], hq64),
             "hq_plain_f64": (p["hq"], hq64),
             "hq_kernel_f64prefix": (k["hq"], hqm),
             "hq_plain_f64prefix": (p["hq"], hqm),
             "xq_kernel_plain": (k["xq"], p["xq"]),
             "xq_kernel_f64": (k["xq"], xq64),
             "xq_plain_f64": (p["xq"], xq64)}
    if b64 is not None:
        pairs.update(boundary_f32_f64=(b32, b64),
                     boundary_f32_f64prefix=(b32, bm))
    out = {"seed": seed}
    for name, (a, b) in pairs.items():
        out[name], out[f"{name}_step"] = apart(a, b)
    return out


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--rays", type=int, default=64)
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--modes", nargs="+", default=["posttap", "both"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/int8_flip_witness.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": card() if dev.type == "cuda" else "cpu",
           "rays": args.rays, "samples": 128, "runs": {}}
    for hid in args.widths:
        for mode in args.modes:
            rows = [one_run(hid, mode, s, args.rays, dev)
                    for s in range(args.seeds)]
            summary = {k: max(row[k] for row in rows)
                       for k in rows[0] if k != "seed"}
            res["runs"][f"{mode}-{hid}"] = {"max": summary, "seeds": rows}
            print(f"{mode}-{hid}: largest over {args.seeds} seeds "
                  f"{json.dumps(summary)}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
