"""The serving defaults' end-to-end gates (``nerfmatch_tpu_torch.e2e.gates:
run``) over several training seeds, on one NVIDIA GPU.

    python3 scripts/gate_seeds.py --root DIR [--seeds 1 2 3]
        [--nerf_epochs 30] [--match_epochs 40] [--out FILE]

For each seed s the NeRF trains with ``exp.seed`` s and the matcher with
s + 1 (seed 1 is the module's own pair, 1 and 2), each in ``DIR/seed<s>``,
with the reported arm ``coarse_eps0`` beside the gates' arms (the serving
default's int8 trunk at ``early_term_eps`` 0).  The gate formulas, limits
and arms are the module's.  Prints one JSON line a seed (every arm's and
protocol's drift, recall, the floor arm's drift, each verdict, the cache
deltas, the ``none`` arm's repeat), then one with the table of all seeds
and the rule below applied:

* not a fault of the port when, on every seed, ``'coarse'`` keeps the
  ``none`` arm's recall under both protocols and its ``--iters 2`` median
  drift is at or under the drift the JAX gate accepted for it
  (:data:`JAX_COARSE_ITERS2`: 1.080 deg / 0.0415, ``PARITY.md``);
* otherwise the bisection's figures say which of early termination and
  the int8 trunk carries the drift.

Exits 0 whatever the verdicts: the record is the result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nerfmatch_tpu_torch.e2e import gates  # noqa: E402

# The JAX gate's record (PARITY.md, the int8 gate run): its floor arm (XLA
# against the fused kernel) and the 'coarse' arm, median dR (deg) / dt.
JAX_FLOOR = {"single": (0.371, 0.0060), "iters2": (1.107, 0.0335)}
JAX_COARSE = {"single": (0.067, 0.0104), "iters2": (1.080, 0.0415)}
JAX_COARSE_ITERS2 = JAX_COARSE["iters2"]


def seed_record(seed, summary):
    """One seed's figures from a ``gates.run`` summary."""
    int8 = summary["int8"]
    arms = {k: {f: v[f] for f in ("dr_med", "dt_med", "dr_max", "dt_max",
                                  "recall_base", "recall", "lim_r", "lim_t",
                                  "ok")}
            for k, v in int8.items() if k != "floor"}
    return {"seed": seed, "floor": int8["floor"], "int8": arms,
            "earlyterm": summary["earlyterm"], "bisect": summary["bisect"],
            "bisect_cache": summary["bisect_cache"], "repeat": summary["repeat"],
            "pass": summary["pass"], "cache_delta": summary["cache_delta"],
            "medians": {k: {f: v[f] for f in ("r_med", "t_med", "recall")}
                        for k, v in summary["results"].items()},
            "seconds": summary["seconds"]}


def decide(records):
    """The rule of the module doc over every seed's record."""
    per_seed = []
    for rec in records:
        keeps = all(rec["int8"][f"coarse/{p}"]["recall"]
                    == rec["int8"][f"coarse/{p}"]["recall_base"]
                    for p, _ in gates.PROTOCOLS)
        d = rec["int8"]["coarse/iters2"]
        within = (d["dr_med"] <= JAX_COARSE_ITERS2[0]
                  and d["dt_med"] <= JAX_COARSE_ITERS2[1])
        per_seed.append({"seed": rec["seed"], "coarse_keeps_recall": keeps,
                         "coarse_iters2_within_jax": within})
    ok = all(s["coarse_keeps_recall"] and s["coarse_iters2_within_jax"]
             for s in per_seed)
    return {"not_a_port_fault": ok, "per_seed": per_seed,
            "jax_floor": JAX_FLOOR, "jax_coarse": JAX_COARSE}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", type=Path, required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--nerf_epochs", type=int, default=30)
    p.add_argument("--match_epochs", type=int, default=40)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    records = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        summary = gates.run(args.root / f"seed{seed}", args.nerf_epochs,
                            args.match_epochs, args.device,
                            nerf_edits={"exp.seed": seed},
                            matcher_edits={"exp.seed": seed + 1},
                            extra_arms=("coarse_eps0",))
        rec = seed_record(seed, summary)
        rec["run_s"] = time.perf_counter() - t0
        records.append(rec)
        print(json.dumps(rec), flush=True)
    out = {"seeds": args.seeds, "nerf_epochs": args.nerf_epochs,
           "match_epochs": args.match_epochs, "records": records,
           "rule": decide(records)}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out))
    print(json.dumps(out["rule"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
