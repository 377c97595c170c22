"""The accuracy ladder (counterpart of ``scripts/accuracy_ladder_tpu.py``):
the pipeline on the enclosed scene at 30 NeRF epochs and the frustum depth
``ENCLOSED_FRUSTUM_DEPTH``, at the configs'
pinned serving mode ``'none'`` (one variable: the NeRF's quality), and the
table of the held-out PSNR against each protocol's pose medians, beside the
JAX package's record of the same ladder (accuracy only).

    python -m nerfmatch_tpu_torch.e2e.ladder --root DIR [--nerf_epochs 30]
        [--match_epochs 40] [--device cuda] [--out FILE]
"""

from __future__ import annotations

from . import pipeline

# The JAX package's ladder on its TPU (PARITY.md:284-297): held-out PSNR
# and (R deg, t scene units) medians; accuracy figures only.
JAX_RECORD = {"psnr": 30.42,
              "single": (5.20, 0.137), "c2f-fine": (3.26, 0.110),
              "iters2": (4.54, 0.125), "iters2+inerf": (5.74, 0.164)}


def table(summary):
    """Rows (protocol, R, t, matches, recall, JAX R, JAX t) and the PSNRs."""
    rows = [(name, p["r_med"], p["t_med"], p["matches"], p["recall"],
             *JAX_RECORD[name]) for name, p in summary["protocols"].items()]
    return {"psnr": summary["psnr"], "jax_psnr": JAX_RECORD["psnr"],
            "rows": rows}


def run(root, nerf_epochs=30, match_epochs=40, device="cuda"):
    summary = pipeline.run(
        root, enclosed=True, nerf_epochs=nerf_epochs,
        match_epochs=match_epochs, device=device,
        frustum_depth=pipeline.ENCLOSED_FRUSTUM_DEPTH)
    summary["ladder"] = table(summary)
    return summary


def main(argv=None):
    p = pipeline.build_parser(__doc__.splitlines()[0])
    p.add_argument("--nerf_epochs", type=int, default=30)
    p.add_argument("--match_epochs", type=int, default=40)
    args = p.parse_args(argv)
    summary = run(args.root, args.nerf_epochs, args.match_epochs, args.device)
    lad = summary["ladder"]
    print(f"== ladder at held-out PSNR {lad['psnr']:.2f} dB "
          f"({args.nerf_epochs} epochs; JAX record {lad['jax_psnr']} dB) ==")
    print(f"{'protocol':>14} | R / t (this run) | matches | recall | JAX R / t")
    for name, r, t, n, rec, jr, jt in lad["rows"]:
        print(f"{name:>14} | {r:6.2f} / {t:.3f} | {n:7d} | {rec:.2f} | "
              f"{jr:.2f} / {jt:.3f}")
    return pipeline.write_summary(summary, args.out)


if __name__ == "__main__":
    main()
