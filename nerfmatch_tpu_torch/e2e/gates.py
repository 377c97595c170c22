"""The serving defaults' end-to-end gates (counterparts of
``scripts/int8_e2e_gate.py`` and ``scripts/earlyterm_e2e_gate.py``): does
localization move when the scene points and the re-render are served by
the int8 trunk (``render.trunk_int8``) or with early ray termination
(``render.early_term_eps``)?

One enclosed-scene NeRF (every ray ends on geometry) is trained; its scene
points are cached once per arm, cold then warm (timed):

* int8 arms: ``none`` (the bf16 kernels), ``plain`` (the noise floor:
  every render on ``render_rays``, the card's plain route, as the JAX
  gate's XLA arm), and the candidates ``coarse``, ``both``, ``posttap``;
  each at the default eps 1e-4;
* early-termination arms: eps 0 and 1e-4 at ``trunk_int8='none'`` (the
  eps-1e-4 arm is the ``none`` arm).

One Mini matcher, trained on the ``none`` cache, localizes every query of
each arm single-shot and at ``--iters 2`` with the arm's cache and
renderer (and the ``none`` arm once more: a control that must not move).
Each arm's cache is compared with the ``none`` arm's (``cache_delta``).
Verdicts (pure functions of the per-query errors):

* int8: recall at (``R_THRES``, ``T_THRES``) equal to ``none``'s, and the
  median drifts within ``max(0.05 deg, 2 x floor)`` and
  ``max(0.002, 2 x floor)``, the floor being the ``plain`` arm's drift;
* early termination: equal recall, every query within 0.5 deg and 0.01.

``extra_arms`` (names of :data:`BISECT_ARMS`) adds arms that no verdict
reads: ``coarse_eps0``, the serving default's int8 trunk without early
termination, whose drift from ``none`` and from ``eps0`` tells which of
the two moves ``coarse`` (``bisect`` in the summary).

    python -m nerfmatch_tpu_torch.e2e.gates --root DIR [--nerf_epochs 30]
        [--match_epochs 40] [--device cuda] [--out FILE]

Exits 1 when any verdict fails, as the JAX gates do.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from ..data.match_dataset import NeRFMatchPair
from ..eval.nerf_evaluator import NerfEvaluator
from ..nerf.renderer import NerfRenderer
from ..utils import resolve_device
from . import pipeline
from .pipeline import recall
from .scene import build_scene

INT8_CANDIDATES = ("coarse", "both", "posttap")
INT8_ARMS = ("none", "plain") + INT8_CANDIDATES
EPS_ARMS = {"eps0": 0.0, "eps1e-4": 1e-4}
# Arms no verdict reads, each against the arms it is compared with.
BISECT_ARMS = {"coarse_eps0": ({"trunk_int8": "coarse", "early_term_eps": 0.0},
                               ("none", "eps0", "coarse"))}
PROTOCOLS = (("single", {}), ("iters2", {"iters": 2}))
ET_MAX_DR, ET_MAX_DT = 0.5, 0.01


class PlainRenderer(NerfRenderer):
    """The noise-floor arm: every render on ``render_rays`` (the route of
    the configs the eval kernels do not serve)."""

    @property
    def fused_eval_supported(self):
        return False


def arm_serving(arm):
    """The cache stage's arguments of an arm."""
    if arm == "plain":
        return {"trunk_int8": "none", "cls": PlainRenderer}
    if arm in EPS_ARMS:
        return {"trunk_int8": "none", "early_term_eps": EPS_ARMS[arm]}
    if arm in BISECT_ARMS:
        return dict(BISECT_ARMS[arm][0])
    return {"trunk_int8": arm}


def drift(base, arm):
    """Drift of one arm's per-query (R_err, t_err) from the base's ->
    dict(median |dR|, median |dt|, per-query max |dR|, |dt|, both
    recalls)."""
    (r0, t0), (r1, t1) = ((np.asarray(r), np.asarray(t)) for r, t in
                          (base, arm))
    return {"dr_med": float(abs(np.median(r1) - np.median(r0))),
            "dt_med": float(abs(np.median(t1) - np.median(t0))),
            "dr_max": float(np.abs(r1 - r0).max()),
            "dt_max": float(np.abs(t1 - t0).max()),
            "recall_base": recall(r0, t0), "recall": recall(r1, t1)}


def cache_delta(base_dir, arm_dir):
    """Largest and mean |difference| of two caches of the same frames:
    ``pt_feat`` scaled by the base's largest value, ``pt3d`` in scene
    units."""
    feat, pts, scale = [], [], 0.0
    for f in sorted(Path(base_dir).glob("*.npy")):
        a = np.load(f, allow_pickle=True).item()
        b = np.load(Path(arm_dir) / f.name, allow_pickle=True).item()
        scale = max(scale, float(np.abs(a["pt_feat"]).max()))
        feat.append(np.abs(b["pt_feat"] - a["pt_feat"]).ravel())
        pts.append(np.abs(b["pt3d"] - a["pt3d"]).ravel())
    feat, pts = np.concatenate(feat) / max(scale, 1e-30), np.concatenate(pts)
    return {"feat_max": float(feat.max()), "feat_mean": float(feat.mean()),
            "pt3d_max": float(pts.max()), "pt3d_mean": float(pts.mean())}


def int8_verdicts(errors, candidates=INT8_CANDIDATES, base="none",
                  floor_arm="plain"):
    """``errors[(arm, proto)] = (R_err, t_err)`` -> {"floor": {proto: the
    floor arm's drift}, (mode, proto): drift with its limits and ``ok``}."""
    protos = sorted({p for _, p in errors})
    floor = {p: drift(errors[base, p], errors[floor_arm, p]) for p in protos}
    out = {"floor": floor}
    for mode in candidates:
        for p in protos:
            d = drift(errors[base, p], errors[mode, p])
            d["lim_r"] = max(0.05, 2 * floor[p]["dr_med"])
            d["lim_t"] = max(0.002, 2 * floor[p]["dt_med"])
            d["ok"] = bool(d["recall_base"] == d["recall"]
                           and d["dr_med"] <= d["lim_r"]
                           and d["dt_med"] <= d["lim_t"])
            out[mode, p] = d
    return out


def earlyterm_verdicts(errors, base="eps0", arm="eps1e-4"):
    """-> {proto: drift of ``arm`` from ``base`` with ``ok``: equal recall
    and every query within ``ET_MAX_DR`` deg and ``ET_MAX_DT``}."""
    out = {}
    for p in sorted({p for _, p in errors}):
        d = drift(errors[base, p], errors[arm, p])
        d["ok"] = bool(d["recall_base"] == d["recall"]
                       and d["dr_max"] < ET_MAX_DR and d["dt_max"] < ET_MAX_DT)
        out[p] = d
    return out


def run(root, nerf_epochs=30, match_epochs=40, device="cuda",
        nerf_edits=None, matcher_edits=None, extra_arms=()):
    """Both gates on one NeRF and one matcher -> summary dict
    (``extra_arms``: :data:`BISECT_ARMS` also run, under ``bisect``)."""
    device = resolve_device(device)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    build_scene(root, enclosed=True)
    t0 = time.perf_counter()
    _, trained = pipeline.train_nerf_stage(
        root, nerf_epochs, frustum_depth=pipeline.ENCLOSED_FRUSTUM_DEPTH,
        device=device, edits=nerf_edits)
    seconds = {"nerf": time.perf_counter() - t0}

    arms = INT8_ARMS + ("eps0",) + tuple(extra_arms)
    caches, renderers, cache_s = {}, {}, {}
    for arm in arms:
        serving = arm_serving(arm)
        cls = serving.pop("cls", NerfRenderer)
        cfg = pipeline.serving_config(
            root, frustum_depth=pipeline.ENCLOSED_FRUSTUM_DEPTH,
            edits=nerf_edits, **serving)
        renderers[arm] = pipeline.eval_renderer(cfg, trained, device, cls=cls)
        ev = NerfEvaluator(cfg, renderers[arm])
        times = []
        for _ in ("cold", "warm"):      # the warm pass: serving steady state
            t0 = time.perf_counter()
            caches[arm] = ev.cache_scene_pts(cache_dir=root / f"cache_{arm}")
            times.append(time.perf_counter() - t0)
        cache_s[arm] = dict(zip(("cold", "warm"), times))
    caches["eps1e-4"], renderers["eps1e-4"] = caches["none"], renderers["none"]
    cache_s["eps1e-4"] = cache_s["none"]

    t0 = time.perf_counter()
    mini = pipeline.train_matchers(root, caches["none"], match_epochs, device,
                                   full=False, edits=matcher_edits)["mini"]
    seconds["matcher"] = time.perf_counter() - t0
    ev = pipeline.evaluator_of(mini, device)

    t0 = time.perf_counter()
    results, errors = {}, {}
    for arm in arms:
        ds = NeRFMatchPair(pipeline.matcher_cfg(
            root, caches[arm], root / "out_match").data, split="test")
        for proto, kw in PROTOCOLS:
            r, t, ns = pipeline.localize(ev, ds, renderers[arm], **kw)
            results[f"{arm}/{proto}"] = pipeline.pose_summary(r, t, ns)
            errors[arm, proto] = (r, t)
    for proto, _ in PROTOCOLS:
        errors["eps1e-4", proto] = errors["none", proto]
        results[f"eps1e-4/{proto}"] = results[f"none/{proto}"]
    # Control: the 'none' arm localized again, on the same cache and
    # renderer (0 unless the localization is not deterministic).
    repeat = {}
    for proto, kw in PROTOCOLS:
        r, t, _ = pipeline.localize(ev, NeRFMatchPair(pipeline.matcher_cfg(
            root, caches["none"], root / "out_match").data, split="test"),
            renderers["none"], **kw)
        repeat[proto] = drift(errors["none", proto], (r, t))
    seconds["localize"] = time.perf_counter() - t0
    deltas = {arm: cache_delta(caches["none"], caches[arm])
              for arm in arms if arm != "none"}

    int8 = int8_verdicts({k: v for k, v in errors.items()
                          if k[0] in INT8_ARMS})
    et = earlyterm_verdicts({k: v for k, v in errors.items()
                             if k[0] in EPS_ARMS})
    bisect = {f"{arm}-{base}/{p}": drift(errors[base, p], errors[arm, p])
              for arm in extra_arms for base in BISECT_ARMS[arm][1]
              for p, _ in PROTOCOLS}
    bisect_cache = {f"{arm}-{base}": cache_delta(caches[base], caches[arm])
                    for arm in extra_arms for base in BISECT_ARMS[arm][1]}
    key = lambda k: k if isinstance(k, str) else "/".join(k)
    return {"nerf_epochs": nerf_epochs, "match_epochs": match_epochs,
            "results": results, "cache_seconds": cache_s,
            "cache_delta": deltas, "repeat": repeat,
            "int8": {key(k): v for k, v in int8.items()},
            "earlyterm": et, "bisect": bisect, "bisect_cache": bisect_cache,
            "seconds": seconds,
            "pass": {"int8": {m: all(int8[m, p]["ok"] for p, _ in PROTOCOLS)
                              for m in INT8_CANDIDATES},
                     "earlyterm": all(v["ok"] for v in et.values())}}


def main(argv=None):
    p = pipeline.build_parser(__doc__.splitlines()[0])
    p.add_argument("--nerf_epochs", type=int, default=30)
    p.add_argument("--match_epochs", type=int, default=40)
    args = p.parse_args(argv)
    summary = pipeline.write_summary(
        run(args.root, args.nerf_epochs, args.match_epochs, args.device),
        args.out)
    ok = all(summary["pass"]["int8"].values()) and summary["pass"]["earlyterm"]
    print("GATE:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
