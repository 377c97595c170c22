"""Port parity of ``nerfmatch_tpu_torch/parallel`` against the JAX package
on the CPU (tiny widths).

* The process layer: both launch contracts of
  ``maybe_initialize_distributed``, ``local_slice``, the train loader's and
  ``ray_batches``' per-rank blocks, the match dataset's per-rank seed.
* Two ``gloo`` processes (``tests/torch_parallel_worker.py``, each run under
  a time limit that kills both ranks): ``all_gather_host``; two NeRF steps
  over a global batch of 512 rays equal to one process's steps and to the
  JAX trainer's on a 2-device mesh; one c2f step over a global batch of 2
  pairs with different positive counts equal to one process's step and to
  the JAX step over the global batch, while the per-rank normalization of
  a plain DDP step differs from it (and equals the JAX ``shard_map`` step,
  which normalizes per device).
* Point-, pair- and ray-sharded evaluation on a port mesh of 4 x ``cpu``
  against the JAX sharded functions on a 4-device mesh and against the
  port's dense paths.
"""

import dataclasses
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.config import save_config
from nerfmatch_tpu.ops import matching as jmatch
from nerfmatch_tpu.parallel import distributed as jdist
from nerfmatch_tpu.parallel.mesh import make_mesh as jmesh
from nerfmatch_tpu.parallel.mesh import shard_batch as jshard_batch

from nerfmatch_tpu_torch.parallel import distributed as tdist
from nerfmatch_tpu_torch.parallel.mesh import make_mesh
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from _cpu import warm_up_vector_math
from _synthetic import build_scene
from test_torch_matcher_train import (LR, TINY, assert_samples_equal,
                                      jax_c2f_step, matcher_config)
from test_torch_models import flat_params, rnd, t
from test_torch_nerf_variants import jax_train_draws
from test_torch_train import nerf_train_config

torch.set_num_threads(2)
# No compared computation below is a thread's first call of a vectorized
# transcendental (tests/_cpu.py); the workers do the same.
warm_up_vector_math()

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
# Both ranks of the worker run take ~15 s here; a hang is killed at this.
WORKER_TIMEOUT_S = 180
CPU4 = ["cpu"] * 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The process layer
# ---------------------------------------------------------------------------

def test_maybe_initialize_distributed_contracts(monkeypatch):
    """No contract: (0, 1) and no group.  The JAX contract and torchrun's
    each form a gloo group on the CPU (world 1) and return (0, 1); a
    second call keeps the group; CUDA without a GPU raises."""
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "NERFMATCH_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.maybe_initialize_distributed(device="cpu") == (0, 1)
    assert not dist.is_initialized() and tdist.DataGroup.current() is None
    jax_env = {"NERFMATCH_COORDINATOR": f"127.0.0.1:{free_port()}",
               "NERFMATCH_NUM_PROCESSES": "1", "NERFMATCH_PROCESS_ID": "0"}
    for env in ("jax", "torchrun"):
        if env == "torchrun":
            for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                         "MASTER_ADDR": "127.0.0.1",
                         "MASTER_PORT": str(free_port())}.items():
                monkeypatch.setenv(k, v)
        try:
            got = tdist.maybe_initialize_distributed(
                jax_env if env == "jax" else None, device="cpu")
            assert got == (0, 1) and dist.get_backend() == "gloo"
            assert tdist.maybe_initialize_distributed(device="cpu") == (0, 1)
            assert tdist.process_info() == (0, 1)
            assert tdist.DataGroup.current().world == 1
        finally:
            dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.maybe_initialize_distributed(jax_env, device="cuda")


def test_local_slice_matches_jax():
    for n in (8, 12, 512):
        for pcount in (1, 2, 4):
            for pid in range(pcount):
                assert tdist.local_slice(n, pid, pcount) == \
                    jdist.local_slice(n, pid, pcount)
    with pytest.raises(AssertionError):
        tdist.local_slice(10, 0, 4)


class _Items:
    def __len__(self):
        return 26

    def __getitem__(self, i):
        return {"i": np.array([i])}


def _ray_set(cls):
    rng = np.random.default_rng(5)
    ds = cls.__new__(cls)
    ds.split, ds.all_msks = "train", None
    ds.all_rays = rng.normal(size=(70, 12)).astype(np.float32)
    ds.all_rgbs = rng.uniform(size=(70, 3)).astype(np.float32)
    ds.all_ts = np.arange(70)[:, None]
    return ds


def test_train_loader_and_ray_batches_split_like_jax(monkeypatch):
    """The train DataLoader and ray_batches of ranks 0 and 1 of 2: each
    rank's batches equal the JAX package's for that process, the two are
    disjoint and together the one-process global batch, in order."""
    from nerfmatch_tpu.data.loaders import DataLoader as JLoader
    from nerfmatch_tpu.data.nerf_dataset import NerfBaseDataset as JSet
    from nerfmatch_tpu_torch.data import nerf_dataset as tset
    from nerfmatch_tpu_torch.data.loaders import DataLoader

    kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=3)
    whole = [b["i"][:, 0] for b in DataLoader(_Items(), **kw)]
    parts = []
    for r in range(2):
        ours = [b["i"][:, 0] for b in DataLoader(
            _Items(), process_index=r, process_count=2, **kw)]
        ref = [b["i"][:, 0] for b in JLoader(
            _Items(), process_index=r, process_count=2, **kw)]
        assert len(ours) == len(whole) == 6
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        parts.append(ours)
    for w, a, b in zip(whole, *parts):
        np.testing.assert_array_equal(np.concatenate([a, b]), w)

    whole = list(_ray_set(tset.NerfBaseDataset).ray_batches(
        16, np.random.default_rng(2)))
    parts = []
    for r in range(2):
        monkeypatch.setattr(tset, "process_info", lambda r=r: (r, 2))
        monkeypatch.setattr(jdist, "process_info", lambda r=r: (r, 2))
        ours = list(_ray_set(tset.NerfBaseDataset).ray_batches(
            16, np.random.default_rng(2)))
        ref = list(_ray_set(JSet).ray_batches(16, np.random.default_rng(2)))
        assert len(ours) == len(ref) == len(whole) == 4
        for a, b in zip(ours, ref):
            for k in ("rays", "rgbs", "ts"):
                np.testing.assert_array_equal(a[k], b[k])
        parts.append(ours)
    for w, a, b in zip(whole, *parts):
        assert not set(a["ts"]) & set(b["ts"])
        np.testing.assert_array_equal(np.concatenate([a["rays"], b["rays"]]),
                                      w["rays"])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("par_scene"),
                       correlated_feats=True)


def test_match_dataset_seeds_by_rank(scene, tmp_path, monkeypatch):
    """NeRFMatchPair's epoch resampling draws from [seed, rank]: rank 1's
    samples equal the JAX dataset's with its process index patched to 1,
    and its pairs are not rank 0's."""
    from nerfmatch_tpu.data.match_dataset import NeRFMatchPair as JPair
    from nerfmatch_tpu_torch.data import match_dataset as tdata

    cfg = matcher_config(scene, tmp_path, epoch_sample_num=8, seed=7)
    cfg.data.scene = "toy"
    draws = {}
    for r in (0, 1):
        monkeypatch.setattr(tdata, "process_info", lambda r=r: (r, 2))
        monkeypatch.setattr(jdist, "process_info", lambda r=r: (r, 2))
        ours = tdata.NeRFMatchPair(cfg.data, split="train")
        ref = JPair(cfg.data, split="train")
        draws[r] = ours.rng.integers(1 << 30, size=8)
        np.testing.assert_array_equal(draws[r],
                                      ref.rng.integers(1 << 30, size=8))
        for i in range(3):
            assert_samples_equal(ours[i], ref[i])
    assert not np.array_equal(draws[0], draws[1])


# ---------------------------------------------------------------------------
# Two gloo processes
# ---------------------------------------------------------------------------

def c2f_batch_uneven():
    """Two pairs with 40 and 12 GT positives."""
    rng = np.random.default_rng(0)
    B, N, M = 2, 64, 64
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    pt2d = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32) * 8 + 4
    conf_gt = np.zeros((B, M, N), np.float32)
    for b, n_pos in enumerate((40, 12)):
        conf_gt[b, rng.choice(M, n_pos, replace=False),
                rng.choice(N, n_pos, replace=False)] = 1
    return {"image": rnd(1, B, 64, 64, 3), "pt_feat": rnd(2, B, N, 24),
            "pt3d": rnd(3, B, N, 3, scale=0.3),
            "im_mask": np.ones((B, M), np.float32),
            "pt_mask": (rng.uniform(size=(B, N)) > 0.1).astype(np.float32),
            "conf_gt": conf_gt,
            "pt2d": np.broadcast_to(pt2d, (B, M, 2)).copy(),
            "pt2d_proj": rng.uniform(0, 64, (B, N, 2)).astype(np.float32)}


def jax_mesh_c2f_step(jm, params, batch, seed=5):
    """The JAX ``C2FTrainStep`` on a 2-device mesh (its ``shard_map`` step:
    per-device losses, keys folded with the device index, ``pmean`` of the
    gradients) -> (new params, loss, the per-device match lists with
    device-local b_ids)."""
    import optax

    from nerfmatch_tpu.train.matcher_trainer import C2FTrainStep as JStep

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(seed)
    opt = optax.sgd(LR)
    p2, _, metrics = JStep(jm, opt, fused_attention=False,
                           mesh=jmesh(data=2, devices=jax.devices()[:2])).step(
        params, opt.init(params),
        *(jb[k] for k in ("image", "pt_feat", "pt3d", "im_mask", "pt_mask",
                          "conf_gt", "pt2d", "pt2d_proj")),
        key, jnp.asarray(False))

    @jax.jit
    def mlist(p, b, k):
        im_cfeat, _ = jm.extract_im_feat_ms(p, b["image"])
        pt_cfeat = jm.extract_pt_feat(p, b["pt_feat"], b["pt3d"])
        im_cfeat, pt_cfeat = jm.apply_coarse_former(p, im_cfeat, pt_cfeat)
        conf = jmatch.dual_softmax(im_cfeat, pt_cfeat, jm.temperature(p),
                                   b["im_mask"], b["pt_mask"],
                                   temp_type=jm.cfg.temp_type)[0]
        return jmatch.pad_matches_with_gt(
            jax.random.split(k)[1], jmatch.extract_mutual_matches(
                conf, mutual=False, threshold=0.0), b["conf_gt"],
            coarse_percent=jm.cfg.coarse_percent, train_percent=0.3)

    lists = []
    for r in range(2):
        one = {k: v[r:r + 1] for k, v in jb.items()}
        m = mlist(params, one, jax.random.fold_in(key, r))
        lists.append({k: torch.from_numpy(np.array(v)) for k, v in m.items()})
    return p2, float(metrics["loss"]), lists


def run_processes(cmds, envs=None, cwd=None):
    """Every command started at once -> their outputs; each must exit 0.
    All are killed and the test fails past ``WORKER_TIMEOUT_S``."""
    envs = envs or [None] * len(cmds)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, env=e, cwd=cwd,
                              stderr=subprocess.STDOUT, text=True)
             for c, e in zip(cmds, envs)]
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks passed {WORKER_TIMEOUT_S} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return logs


def run_ranks(workdir, world=2):
    """The worker in ``world`` processes -> each rank's outputs."""
    port = free_port()
    run_processes([[sys.executable, str(WORKER), str(r), str(world),
                    str(port), str(workdir)] for r in range(world)])
    return [torch.load(workdir / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def assert_same_deltas(got, want, start, rtol=1e-5):
    """Two trainings' parameter updates from ``start``: every element within
    ``rtol`` of the leaf's largest update in ``want``; a leaf whose update
    lies below 1e-5 of the model's largest (zero in exact arithmetic, as
    ``assert_deltas_match`` has it) below that floor in ``got`` too."""
    assert got.keys() == want.keys()
    deltas = {k: (got[k] - start[k], w - start[k]) for k, w in want.items()}
    floor = 1e-5 * max(float(d.abs().max()) for _, d in deltas.values())
    for k, (d_got, d_want) in deltas.items():
        scale = float(d_want.abs().max())
        if scale <= floor:
            assert float(d_got.abs().max()) <= floor, k
            continue
        assert float((d_got - d_want).abs().max()) <= rtol * scale, \
            (k, float((d_got - d_want).abs().max()), scale)


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    """Inputs, JAX references and one-process port runs; then the two
    ranks -> dict of all of them."""
    from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JCfg
    from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JMS
    from nerfmatch_tpu.train.nerf_trainer import NerfTrainer as JTrainer
    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                        NeRFMatcherMS)
    from nerfmatch_tpu_torch.train.matcher_trainer import C2FTrainStep
    from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer

    work = tmp_path_factory.mktemp("ranks")
    out = {}
    # NeRF: SGD, perturb on, noise 1, the plain route (the JAX trainer's XLA
    # step, whose draws have the global batch's shape on any mesh).
    cfg = nerf_train_config(scene, work / "nerf", hid=32, layers=4,
                            skips=(2,), pts=16, noise_std=1.0)
    cfg.optim.optimizer, cfg.optim.lr = "sgd", 0.5
    cfg.exp.gpus, cfg.exp.batch_size = 0, 512
    save_config(work / "nerf.yaml", cfg)
    jt = JTrainer(cfg, num_frames=1, mesh=jmesh(data=2,
                                               devices=jax.devices()[:2]))
    params, opt_state = jt.init_state(0)
    start = state_dict_from_jax(flat_params(params))
    step = jt.train_step_fn()
    ds = init_data_loader(cfg.data, split="train").dataset
    draws, jlosses = [], []
    for i, b in enumerate(ds.ray_batches(512, np.random.default_rng(0))):
        if i == 2:
            break
        key = jax.random.PRNGKey(10 + i)
        sb = jshard_batch(b, jt.mesh)
        params, opt_state, m = step(params, opt_state, sb["rays"], sb["rgbs"],
                                    sb["ts"].astype(jnp.int32), key)
        jlosses.append(float(m["loss"]))
        draws.append(jax_train_draws(key, 512, 16, 16, True))
    out["nerf"] = dict(start=start, jax_losses=jlosses,
                       jax_params=state_dict_from_jax(flat_params(params)))
    tt = NerfTrainer(cfg, device="cpu")
    tt.renderer.load_state_dict(start, strict=True)
    gen = torch.Generator().manual_seed(7)
    losses = [float(tt.train_step(t(b["rays"]), t(b["rgbs"]), gen)["loss"])
              for b, _ in zip(ds.ray_batches(512, np.random.default_rng(0)),
                              range(2))]
    out["nerf"]["one_process"] = (losses, tt.renderer.state_dict())

    # c2f: SGD at LR; the JAX step over the global batch and on a mesh.
    jm = JMS(JCfg(**TINY))
    jparams = jm.init_params(jax.random.PRNGKey(3))
    batch = c2f_batch_uneven()
    p1, jmetr, mlist = jax_c2f_step(jm, jparams, batch)
    p2, mesh_loss, mlists = jax_mesh_c2f_step(jm, jparams, batch)
    c2f_start = state_dict_from_jax(flat_params(jparams),
                                    backbone_extra="model.")
    out["c2f"] = dict(jm=jm, jparams=jparams, global_params=p1,
                      global_loss=float(jmetr["loss"]), mesh_params=p2,
                      mesh_loss=mesh_loss, start=c2f_start)
    for mode in ("global", "generator"):
        tm = NeRFMatcherMS(C2FMatcherConfig(**TINY))
        tm.load_state_dict(c2f_start, strict=True)
        st = C2FTrainStep(tm, torch.optim.SGD(tm.parameters(), lr=LR,
                                              momentum=0.0),
                          generator=torch.Generator().manual_seed(11))
        m = st.step({k: t(v) for k, v in batch.items()},
                    mlist=mlist if mode == "global" else None)
        out["c2f"][f"one_process_{mode}"] = (float(m["loss"]),
                                             tm.state_dict())

    torch.save({"nerf_cfg": str(work / "nerf.yaml"), "nerf_start": start,
                "nerf_draws": draws, "c2f_cfg": TINY, "c2f_start": c2f_start,
                "c2f_batch": batch, "lr": LR, "mlist": mlist,
                "mlists_per_rank": mlists}, work / "inputs.pt")
    out["ranks"] = run_ranks(work)
    return out


def test_all_gather_host_two_ranks(ranks):
    for r in ranks["ranks"]:
        assert r["gathered"] == [0, 10, 1, 11]


def test_two_rank_nerf_steps_match_one_process_and_jax_mesh(ranks):
    """Two steps over 512 rays (256 a rank): with the trainer's generator
    equal to one process's steps (loss and parameters at 1e-6); with the
    JAX step's draws injected, the JAX trainer's steps on a 2-device mesh
    (loss rtol 1e-5, updates within 1e-4 of each leaf's largest)."""
    nerf = ranks["nerf"]
    for r in ranks["ranks"]:
        losses, state = r["nerf_generator"]
        ref_losses, ref_state = nerf["one_process"]
        np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-6)
        for k, v in ref_state.items():
            torch.testing.assert_close(state[k], v, rtol=0, atol=1e-6)
        losses, state = r["nerf_injected"]
        np.testing.assert_allclose(losses, nerf["jax_losses"], rtol=1e-5)
        assert_same_deltas(state, nerf["jax_params"], nerf["start"],
                           rtol=1e-4)
    assert nerf["one_process"][0] != ranks["ranks"][0]["nerf_injected"][0]


def test_two_rank_c2f_step_normalizes_over_the_global_batch(ranks):
    """One c2f step, one pair a rank with 40 and 12 positives: the global
    normalizers give one process's step over both pairs (injected global
    match list, and the step's own generator), and the JAX step over the
    global batch; the per-rank normalization of a plain DDP step fails
    that and equals the JAX shard_map step instead (per-device lists).
    Updates within 1e-4 of each leaf's largest against one process (the
    ranks sum gradients in another order: up to 3e-5 here), 2e-4 against
    JAX (one process holds 1e-4; the StarReLU scales, scalars summed over
    whole feature maps, take the ranks' rounding on top: 1.02e-4)."""
    c2f = ranks["c2f"]
    for r in ranks["ranks"]:
        for mode in ("global", "generator"):
            loss, state = r[f"c2f_{mode}"]
            ref_loss, ref_state = c2f[f"one_process_{mode}"]
            assert loss == pytest.approx(ref_loss, rel=1e-6)
            assert_same_deltas(state, ref_state, c2f["start"], rtol=1e-4)
        assert r["c2f_global"][0] == pytest.approx(c2f["global_loss"],
                                                   rel=1e-5)
        assert r["c2f_per_rank"][0] == pytest.approx(c2f["mesh_loss"],
                                                     rel=1e-5)
        with pytest.raises(AssertionError):
            assert_same_deltas(r["c2f_per_rank"][1],
                               c2f["one_process_global"][1], c2f["start"],
                               rtol=1e-3)
    for key, jax_params in (("c2f_global", c2f["global_params"]),
                            ("c2f_per_rank", c2f["mesh_params"])):
        assert_same_deltas(ranks["ranks"][0][key][1], state_dict_from_jax(
            flat_params(jax_params), backbone_extra="model."), c2f["start"],
            rtol=2e-4)


def test_matcher_cli_validates_across_three_ranks(scene, tmp_path):
    """``cli.train_nerfmatch --stage c2f --debug`` in three gloo ranks under
    ``NERFMATCH_*``, one pair a rank: the debug validation keeps two
    batches, so rank 2 sees none and still joins the one gather; every
    rank logs the same validation metrics, and rank 0 alone writes the
    checkpoints."""
    import os

    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import init_config_odir

    cfg = matcher_config(scene, tmp_path / "out", coarse=False)
    cfg.exp.gpus, cfg.exp.batch_size = 0, 3
    save_config(tmp_path / "cfg.yaml", cfg)
    root = Path(__file__).resolve().parent.parent
    port = free_port()
    envs = [dict(os.environ, OMP_NUM_THREADS="2",
                 NERFMATCH_COORDINATOR=f"127.0.0.1:{port}",
                 NERFMATCH_NUM_PROCESSES="3", NERFMATCH_PROCESS_ID=str(r))
            for r in range(3)]
    cmd = [sys.executable, "-m", "nerfmatch_tpu_torch.cli.train_nerfmatch",
           "--config", str(tmp_path / "cfg.yaml"), "--stage", "c2f",
           "--debug", "--device", "cpu"]
    logs = run_processes([cmd] * 3, envs, cwd=root)
    val = [[ln.split("epoch 0: ", 1)[1] for ln in log.splitlines()
            if "epoch 0: val {" in ln] for log in logs]
    assert len(val[0]) == 1 and val[1] == val[0] and val[2] == val[0], val
    cfg.gpu_num = 3
    ckpts = init_config_odir(cfg, False) / "checkpoints"
    assert latest_checkpoint(ckpts, name="last").name == "last_1"


# ---------------------------------------------------------------------------
# Sharded evaluation on a mesh of 4 x cpu
# ---------------------------------------------------------------------------

def test_sharded_point_match_matches_jax_and_dense():
    """sharded_point_match at the JAX test's shapes and variants (mutual on
    / off, temperature mul / div, threshold 0 / 1e-4, masks): valid and
    j_ids identical to the port's dense extraction and to JAX's sharded
    function on a 4-device mesh; mconf within 1e-6."""
    from nerfmatch_tpu.parallel.point_sharding import sharded_point_match as js
    from nerfmatch_tpu_torch.ops.matching import (dual_softmax,
                                                  extract_mutual_matches)
    from nerfmatch_tpu_torch.parallel.point_sharding import sharded_point_match

    B, M, N, D = 2, 24, 64, 16
    rng = np.random.default_rng(0)
    im = rng.normal(size=(B, M, D)).astype(np.float32)
    pt = rng.normal(size=(B, N, D)).astype(np.float32)
    im_mask = (rng.uniform(size=(B, M)) > 0.2).astype(np.float32)
    pt_mask = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    mesh = make_mesh(devices=CPU4)
    for mutual, thr, ttype in [(True, 0.0, "mul"), (False, 1e-4, "div")]:
        conf, _, _ = dual_softmax(t(im), t(pt), torch.tensor(10.0),
                                  t(im_mask), t(pt_mask), temp_type=ttype)
        dense = extract_mutual_matches(conf, mutual=mutual, threshold=thr)
        ours = sharded_point_match(mesh, t(im), t(pt), torch.tensor(10.0),
                                   t(im_mask), t(pt_mask), temp_type=ttype,
                                   mutual=mutual, threshold=thr)
        ref = js(jmesh(data=4, devices=jax.devices()[:4]), jnp.asarray(im),
                 jnp.asarray(pt), jnp.asarray(10.0), jnp.asarray(im_mask),
                 jnp.asarray(pt_mask), temp_type=ttype, mutual=mutual,
                 threshold=thr)
        v = dense["valid"].numpy()
        assert v.sum() > 5
        for other in (dense, {k: torch.from_numpy(np.array(x))
                              for k, x in ref.items()}):
            np.testing.assert_array_equal(ours["valid"].numpy(),
                                          other["valid"].numpy())
            np.testing.assert_array_equal(ours["j_ids"].numpy()[v],
                                          other["j_ids"].numpy()[v])
            np.testing.assert_allclose(ours["mconf"].numpy(),
                                       other["mconf"].numpy(), atol=1e-6)


POINT_CFG = dict(backbone="tiny", pretrained=False, cfeat_dim=32, pt_dim=16,
                 im_pe=True, im_sa=1, im_sa_type="share", pt_sa=1,
                 pt_sa_type="full", pt_pe=True, coarse_layers=1)
C2F_CFG = dict(POINT_CFG, ffeat_dim=16, fine_sa=1, fsa_type="full", win_sz=5,
               cat_c_feat=True)


def model_pair(kind):
    from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JC2F
    from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JMS
    from nerfmatch_tpu.models.matcher_coarse import CoarseMatcherConfig as JCC
    from nerfmatch_tpu.models.matcher_coarse import NeRFMatcherCoarse as JC
    from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                        NeRFMatcherMS)
    from nerfmatch_tpu_torch.models.matcher_coarse import (
        CoarseMatcherConfig, NeRFMatcherCoarse)

    JM, JCfg, TM, TCfg, cfg = {
        "coarse": (JC, JCC, NeRFMatcherCoarse, CoarseMatcherConfig,
                   POINT_CFG),
        "c2f": (JMS, JC2F, NeRFMatcherMS, C2FMatcherConfig, C2F_CFG)}[kind]
    jm = JM(JCfg(**cfg, fused_attention_train=False))
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = TM(TCfg(**cfg))
    tm.load_state_dict(state_dict_from_jax(
        flat_params(params),
        **({"backbone_extra": "model."} if kind == "c2f" else {})),
        strict=True)
    return jm, params, tm.eval()


def assert_matches(got, want, lists_too=True, expec_atol=None, conf_atol=1e-6):
    """Dense matches (and top-k lists) equal where valid; mconf (and
    expec_f on valid tokens) within the tolerances."""
    g = {k: np.asarray(v) for k, v in got.items() if k != "lists"}
    w = {k: np.asarray(v) for k, v in want.items() if k != "lists"}
    v = w["valid"]
    np.testing.assert_array_equal(g["valid"], v)
    np.testing.assert_array_equal(g["j_ids"][v], w["j_ids"][v])
    np.testing.assert_allclose(g["mconf"], w["mconf"], atol=conf_atol)
    if expec_atol is not None:
        shape = (*v.shape, 3)
        np.testing.assert_allclose(g["expec_f"].reshape(shape)[v],
                                   w["expec_f"].reshape(shape)[v],
                                   atol=expec_atol)
    if lists_too:
        lv = np.asarray(want["lists"]["valid"])
        for k in ("i_ids", "j_ids", "valid"):
            np.testing.assert_array_equal(np.asarray(got["lists"][k])[lv],
                                          np.asarray(want["lists"][k])[lv], k)


@pytest.mark.parametrize("kind,n", [("coarse", 64), ("c2f", 640)])
def test_eval_match_point_sharded_matches_jax_and_dense(kind, n):
    """eval_match_point_sharded of the tiny coarse and c2f matchers (a
    merged 10-pair cloud for the c2f) on exported weights: against the
    port's dense eval_match as the JAX test holds its own (valid, j_ids and
    the lists identical, mconf 1e-6, expec_f 1e-5), and against JAX's
    eval_match_point_sharded on a 4-device mesh (mconf 1e-4, expec_f
    1e-4, as the port's dense matcher against JAX's)."""
    jm, params, tm = model_pair(kind)
    rng = np.random.default_rng(2 if kind == "coarse" else 4)
    img = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    pt_feat = rng.normal(size=(1, n, 16)).astype(np.float32)
    pt3d = rng.normal(size=(1, n, 3)).astype(np.float32)
    im_mask = (rng.uniform(size=(1, 16)) > 0.1).astype(np.float32)
    pt_mask = (rng.uniform(size=(1, n)) > 0.1).astype(np.float32)
    kw = dict(im_mask=t(im_mask), pt_mask=t(pt_mask), mutual=True, top_k=32)
    dense = tm.eval_match(t(img), t(pt_feat), t(pt3d), **kw)
    ours = tm.eval_match_point_sharded(make_mesh(devices=CPU4), t(img),
                                       t(pt_feat), t(pt3d), **kw)
    assert dense["valid"].sum() > 3
    c2f = kind == "c2f"
    assert_matches(ours, dense, expec_atol=1e-5 if c2f else None)
    ref = jm.eval_match_point_sharded(
        params, jmesh(data=4, devices=jax.devices()[:4]), jnp.asarray(img),
        jnp.asarray(pt_feat), jnp.asarray(pt3d),
        im_mask=jnp.asarray(im_mask), pt_mask=jnp.asarray(pt_mask),
        mutual=True, top_k=32)
    assert_matches(ours, ref, conf_atol=1e-4, expec_atol=1e-4 if c2f else None)


def test_pair_sharded_multi_pair_matches_jax_and_serial():
    """forward_multi_pair(pair_mesh=) through eval_match at K = 5 pairs
    padded onto 4 shards (the JAX test's shapes): equal to the port's pairs
    one after the other (bit for bit) and to JAX's pair-sharded path on a
    4-device mesh (lists where valid, mconf and expec_f 1e-4)."""
    jm, params, tm = model_pair("c2f")
    rng = np.random.default_rng(3)
    K, n = 5, 24
    img = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    pt_feat = rng.normal(size=(1, K, n, 16)).astype(np.float32)
    pt3d = rng.normal(size=(1, K, n, 3)).astype(np.float32)
    pt_mask = (rng.uniform(size=(1, K, n)) > 0.1).astype(np.float32)
    kw = dict(pt_mask=t(pt_mask), mutual=True, top_k=16)
    serial = tm.eval_match(t(img), t(pt_feat), t(pt3d), **kw)
    ours = tm.eval_match(t(img), t(pt_feat), t(pt3d),
                         pair_mesh=make_mesh(devices=CPU4), **kw)
    assert ours["j_ids"].shape == (K, 1, 16)
    for k in ("j_ids", "mconf", "valid", "expec_f"):
        torch.testing.assert_close(ours[k], serial[k], rtol=0, atol=0)
    for k in ("i_ids", "j_ids", "mconf", "valid"):
        torch.testing.assert_close(ours["lists"][k], serial["lists"][k],
                                   rtol=0, atol=0)
    ref = jm.eval_match(params, jnp.asarray(img), jnp.asarray(pt_feat),
                        jnp.asarray(pt3d), pt_mask=jnp.asarray(pt_mask),
                        mutual=True, top_k=16,
                        pair_mesh=jmesh(data=4, devices=jax.devices()[:4]))
    lv = np.asarray(ref["lists"]["valid"])
    assert lv.sum() > 5
    np.testing.assert_array_equal(ours["lists"]["valid"].numpy(), lv)
    for k in ("i_ids", "j_ids"):
        np.testing.assert_array_equal(ours["lists"][k].numpy()[lv],
                                      np.asarray(ref["lists"][k])[lv])
    np.testing.assert_allclose(ours["lists"]["mconf"].numpy(),
                               ref["lists"]["mconf"], atol=1e-4)
    np.testing.assert_allclose(ours["expec_f"].numpy(), ref["expec_f"],
                               atol=1e-4)


def test_replicas_follow_the_weights():
    """A model copy per mesh device is cached and dropped when the weights
    change (an in-place update) or the config does."""
    from nerfmatch_tpu_torch.parallel.mesh import Mesh, replicas

    lin = torch.nn.Linear(3, 2)
    mesh = Mesh((torch.device("cpu"), torch.device("meta")))
    a = replicas(lin, mesh)
    assert a[0] is lin and a[1].weight.device.type == "meta"
    assert replicas(lin, mesh)[1] is a[1]
    with torch.no_grad():
        lin.weight.add_(1.0)
    assert replicas(lin, mesh)[1] is not a[1]


def test_sharded_render_matches_unsharded_and_jax():
    """make_sharded_render over 4 x cpu on 64 rays (the plain stages): equal
    to fused_predict on all of them bit for bit; with the stages' MLP in f32
    (early termination off), to JAX's XLA render of the same rays (fine
    outputs by mean 2e-5 / p99 2e-4, the plain path's own tolerance against
    render_rays); an appearance renderer without rows raises."""
    from nerfmatch_tpu.nerf.renderer import NerfRenderer as JRenderer
    from nerfmatch_tpu_torch.nerf import renderer as renderer_mod
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from nerfmatch_tpu_torch.ops.kernels.render_kernel import \
        render_stage_plain
    from nerfmatch_tpu_torch.parallel.render_sharding import \
        make_sharded_render

    from test_torch_nerf import make_rays, nerf_config

    cfg = nerf_config(early_term_eps=0.0)
    jr = JRenderer(cfg, stop_layer=3)
    params = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 3.0
    tr = NerfRenderer(cfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    rays = t(make_rays(64, 4, nonunit=True))
    mesh = make_mesh(devices=CPU4)
    render = make_sharded_render(mesh, tr)
    with torch.no_grad():
        got, want = render(rays), tr.fused_predict(rays)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
        plain = renderer_mod.render_stage
        renderer_mod.render_stage = lambda *a, packed=None, **kw: \
            render_stage_plain(*a, trunk_bf16=False, **kw)
        try:
            f32 = render(rays)
        finally:
            renderer_mod.render_stage = plain
    ref = jr.render_rays(params, jnp.asarray(rays.numpy()), train=False,
                         ret_pfeat=True, validation=True)
    for k in ("rgb_fine", "depth_fine", "pts_fine", "feat_fine"):
        err = np.abs(f32[k].numpy().reshape(np.shape(ref[k]))
                     - np.asarray(ref[k]))
        assert err.mean() < 2e-5 and np.quantile(err, 0.99) < 2e-4, \
            (k, err.max())
    tr.cfg = dataclasses.replace(tr.cfg, appearance_embedding=True)
    with pytest.raises(ValueError, match="app rows"):
        make_sharded_render(mesh, tr)(rays)

