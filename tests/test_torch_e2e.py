"""The end-to-end accuracy path of the port against the JAX package's
scripts on the CPU: the synthetic scene (byte for byte), the pipeline's
configs, the gates' verdict arithmetic, and the e2e entry points' device
rule.  The JAX scripts are loaded from ``scripts/`` with the persistent
compile cache off."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmatch_tpu_torch.config import namespace2dict
from nerfmatch_tpu_torch.e2e import (gates, ladder, parity_artifacts,
                                     pipeline, scene)

ROOT = Path(__file__).resolve().parents[1]


def load_script(monkeypatch, name):
    """``scripts/<name>.py`` as a module, imported with the compile cache
    off (``enable_compile_cache`` runs at import) and the environment
    restored afterwards (the gate scripts set ``E2E_ENCLOSED``)."""
    monkeypatch.setenv("NERFMATCH_COMPILE_CACHE", "0")
    monkeypatch.setenv("E2E_ENCLOSED", "0")
    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_e2e(monkeypatch):
    return load_script(monkeypatch, "e2e_full_pipeline_tpu")


def tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("app_seqs,enclosed", [(0, False), (4, False),
                                               (0, True)],
                         ids=["plain", "app_seqs4", "enclosed"])
def test_build_scene_matches_jax_byte_for_byte(jax_e2e, monkeypatch, tmp_path,
                                               app_seqs, enclosed):
    """The frames (PNG bytes), the ``transforms_{train,val,test}.json`` and
    the pair files equal the JAX script's, file for file."""
    monkeypatch.setattr(jax_e2e, "ENCLOSED", enclosed)
    jax_e2e.build_scene(tmp_path / "jax", app_seqs=app_seqs)
    scene.build_scene(tmp_path / "port", app_seqs=app_seqs, enclosed=enclosed)
    want, got = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert len(want) == scene.N_TRAIN + scene.N_TEST + 5
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want)


def test_scene_constants_and_configs_match_jax(jax_e2e, tmp_path):
    """The scene's constants, and ``nerf_config`` / ``matcher_cfg`` as dicts
    over every argument the scripts pass."""
    for name in ("W", "H", "DS", "FOCAL", "CAM_R", "BALL_R", "SHELL_R",
                 "N_TRAIN", "N_TEST"):
        assert getattr(scene, name) == getattr(jax_e2e, name), name
    np.testing.assert_array_equal(scene.look_at([1.0, 0.3, -2.0]),
                                  jax_e2e.look_at([1.0, 0.3, -2.0]))
    root, odir, cache = tmp_path, tmp_path / "out", tmp_path / "cache"
    for kw in ({}, {"epochs": 30}, {"epochs": 3, "app": True}):
        assert namespace2dict(pipeline.nerf_config(root, odir, **kw)) == \
            namespace2dict(jax_e2e.nerf_config(root, odir, **kw))
    for kw in ({}, {"epochs": 2, "c2f": True}, {"multipair": True}):
        assert namespace2dict(pipeline.matcher_cfg(root, cache, odir, **kw)) \
            == namespace2dict(jax_e2e.matcher_cfg(root, cache, odir, **kw))


def jax_int8_verdicts(results, candidates):
    """``scripts/int8_e2e_gate.py:150-185``, transcribed: results[(mode,
    proto)] = (r, t) -> (floor, {(mode, proto): (dmr, dmt, dr, dt, rec0,
    rec1, lim_r, lim_t, ok)})."""
    R_THRES, T_THRES = 5.0, 0.05

    def drift(mode, proto):
        r0, t0_ = results["none", proto]
        r1, t1 = results[mode, proto]
        rec0 = float(np.mean((r0 < R_THRES) & (t0_ < T_THRES)))
        rec1 = float(np.mean((r1 < R_THRES) & (t1 < T_THRES)))
        return (abs(np.median(r1) - np.median(r0)),
                abs(np.median(t1) - np.median(t0_)),
                np.abs(r1 - r0).max(), np.abs(t1 - t0_).max(), rec0, rec1)

    floor = {}
    for proto in ("single", "iters2"):
        dmr, dmt, _, _, _, _ = drift("xla", proto)
        floor[proto] = (dmr, dmt)
    out = {}
    for mode in candidates:
        for proto in ("single", "iters2"):
            dmr, dmt, dr, dt, rec0, rec1 = drift(mode, proto)
            lim_r = max(0.05, 2 * floor[proto][0])
            lim_t = max(0.002, 2 * floor[proto][1])
            ok_i = (rec0 == rec1) and dmr <= lim_r and dmt <= lim_t
            out[mode, proto] = (dmr, dmt, dr, dt, rec0, rec1, lim_r, lim_t,
                                ok_i)
    return floor, out


def jax_earlyterm_verdicts(results):
    """``scripts/earlyterm_e2e_gate.py:124-139``, transcribed."""
    R_THRES, T_THRES = 5.0, 0.05
    out = {}
    for proto in ("single", "iters2"):
        r0, t0_ = results[0.0, proto]
        r1, t1 = results[1e-4, proto]
        dr, dt = np.abs(r1 - r0).max(), np.abs(t1 - t0_).max()
        rec0 = float(np.mean((r0 < R_THRES) & (t0_ < T_THRES)))
        rec1 = float(np.mean((r1 < R_THRES) & (t1 < T_THRES)))
        out[proto] = (dr, dt, rec0, rec1,
                      rec0 == rec1 and dr < 0.5 and dt < 0.01)
    return out


def seeded_errors(seed, arms, n=12):
    """Per-query (R_err, t_err) of each arm and protocol: a base drawn from
    gammas (some failed PnPs, some queries under the recall thresholds), the
    other arms the base moved by arm-sized noise."""
    rng = np.random.default_rng(seed)
    out = {}
    for proto in ("single", "iters2"):
        r = rng.gamma(2.0, 2.5, n)
        t = rng.gamma(2.0, 0.03, n)
        r[rng.integers(n)] = np.inf
        for arm, scale in arms.items():
            rr = np.maximum(r + rng.normal(0, scale, n), 0.0)
            tt = np.maximum(t + rng.normal(0, scale / 50, n), 0.0)
            out[arm, proto] = (r if scale == 0 else rr,
                               t if scale == 0 else tt)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_gate_verdicts_match_jax_formulas(seed):
    """``gates.int8_verdicts`` and ``earlyterm_verdicts`` on seeded drifts
    give the values and verdicts of the JAX gates' formulas (the port's
    ``plain`` arm in the JAX ``xla`` arm's place)."""
    scales = {"none": 0.0, "xla": 0.1 * (seed % 3), "coarse": 0.02,
              "both": 0.5, "posttap": 0.05 * seed}
    res = seeded_errors(seed, scales)
    floor, want = jax_int8_verdicts(res, gates.INT8_CANDIDATES)
    ours = {(("plain" if a == "xla" else a), p): v for (a, p), v in res.items()}
    got = gates.int8_verdicts(ours)
    for proto, (dmr, dmt) in floor.items():
        assert got["floor"][proto]["dr_med"] == dmr
        assert got["floor"][proto]["dt_med"] == dmt
    names = ("dr_med", "dt_med", "dr_max", "dt_max", "recall_base", "recall",
             "lim_r", "lim_t", "ok")
    for key, vals in want.items():
        for name, v in zip(names, vals):
            np.testing.assert_equal(got[key][name], v, err_msg=f"{key} {name}")
    et_res = {(eps, p): res[arm, p] for eps, arm in ((0.0, "none"),
                                                     (1e-4, "posttap"))
              for p in ("single", "iters2")}
    et_want = jax_earlyterm_verdicts(et_res)
    et = gates.earlyterm_verdicts({(("eps0" if e == 0 else "eps1e-4"), p): v
                                   for (e, p), v in et_res.items()})
    for proto, vals in et_want.items():
        for name, v in zip(("dr_max", "dt_max", "recall_base", "recall", "ok"),
                           vals):
            np.testing.assert_equal(et[proto][name], v)


def test_gate_verdicts_cover_both_outcomes():
    """The seeded drifts above give passing and failing int8 verdicts."""
    oks = set()
    for seed in range(6):
        res = seeded_errors(seed, {"none": 0.0, "plain": 0.1 * (seed % 3),
                                   "coarse": 0.02, "both": 0.5,
                                   "posttap": 0.05 * seed})
        v = gates.int8_verdicts(res)
        oks |= {v[k]["ok"] for k in v if k != "floor"}
    assert oks == {True, False}


def test_gate_constants_match_jax(monkeypatch):
    """Recall thresholds and the int8 arms of the JAX gate (its default
    candidates and the ``posttap`` mode its environment variable adds)."""
    import os

    before = os.environ.get("E2E_ENCLOSED")
    int8 = load_script(monkeypatch, "int8_e2e_gate")
    et = load_script(monkeypatch, "earlyterm_e2e_gate")
    assert (int8.R_THRES, int8.T_THRES) == (et.R_THRES, et.T_THRES) == \
        (pipeline.R_THRES, pipeline.T_THRES)
    assert set(int8.CANDIDATES) | {"posttap"} == set(gates.INT8_CANDIDATES)
    assert tuple(et.EPS_GRID) == tuple(gates.EPS_ARMS.values())
    monkeypatch.undo()
    assert os.environ.get("E2E_ENCLOSED") == before


ENTRY_POINTS = [scene.main, pipeline.main, parity_artifacts.main, ladder.main,
                gates.main]


@pytest.mark.parametrize("entry", ENTRY_POINTS,
                         ids=lambda f: f.__module__.rsplit(".", 1)[1])
def test_e2e_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    """With CUDA hidden every ``python -m nerfmatch_tpu_torch.e2e.*`` entry
    point raises before it writes anything; ``--device cpu`` reaches the
    stages with the CPU (``scene.main`` writes the scene; the others' stage
    runner is replaced by a recorder)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "run"
    argv = [str(out)] if entry is scene.main else ["--root", str(out)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(argv)
    assert not out.exists()
    seen = []

    def record(*a, **kw):
        seen.append(str(kw.get("device", a[3] if len(a) > 3 else None)))
        raise StopIteration

    for mod, name in ((pipeline, "run"), (parity_artifacts, "make_artifacts"),
                      (gates, "run")):
        monkeypatch.setattr(mod, name, record)
    if entry is scene.main:
        assert entry(argv + ["--device", "cpu"]) == out
        assert (out / "pairs_test.txt").exists()
        return
    with pytest.raises(StopIteration):
        entry(argv + ["--device", "cpu"])
    assert seen == ["cpu"]


def test_bisect_arm_is_reported_not_gated(monkeypatch):
    """``coarse_eps0`` (``gates.BISECT_ARMS``) serves the int8 trunk at eps
    0, and no verdict reads it: the int8 and early-termination verdicts of
    seeded drifts are the same with and without it.  ``scripts/
    gate_seeds.py: decide`` calls a seed clean only where ``'coarse'`` keeps
    ``none``'s recall under both protocols and its ``--iters 2`` median
    drift is within the JAX gate's accepted 1.080 deg / 0.0415."""
    assert gates.arm_serving("coarse_eps0") == {"trunk_int8": "coarse",
                                                "early_term_eps": 0.0}
    res = seeded_errors(3, {"none": 0.0, "plain": 0.1, "coarse": 0.02,
                            "both": 0.5, "posttap": 0.15, "eps0": 0.01,
                            "eps1e-4": 0.0, "coarse_eps0": 3.0})
    without = {k: v for k, v in res.items() if k[0] != "coarse_eps0"}
    pick = lambda r, arms: {k: v for k, v in r.items() if k[0] in arms}
    np.testing.assert_equal(gates.int8_verdicts(pick(res, gates.INT8_ARMS)),
                            gates.int8_verdicts(pick(without, gates.INT8_ARMS)))
    np.testing.assert_equal(
        gates.earlyterm_verdicts(pick(res, gates.EPS_ARMS)),
        gates.earlyterm_verdicts(pick(without, gates.EPS_ARMS)))
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import gate_seeds

    def record(seed, rec_single, rec_iters2, dr, dt):
        d = lambda rb, r, dr_, dt_: {"recall_base": rb, "recall": r,
                                     "dr_med": dr_, "dt_med": dt_}
        return {"seed": seed, "int8": {
            "coarse/single": d(0.0, rec_single, 0.1, 0.01),
            "coarse/iters2": d(0.0, rec_iters2, dr, dt)}}
    clean = record(1, 0.0, 0.0, 1.080, 0.0415)
    assert gate_seeds.decide([clean])["not_a_port_fault"]
    for bad in (record(2, 0.0, 1 / 12, 0.2, 0.01),
                record(3, 1 / 12, 0.0, 0.2, 0.01),
                record(4, 0.0, 0.0, 1.081, 0.01),
                record(5, 0.0, 0.0, 0.2, 0.0416)):
        assert not gate_seeds.decide([clean, bad])["not_a_port_fault"]
