"""Port parity: concatenated multi-scene and mixed datasets, and matcher
training over them, against the JAX package on the CPU.

Two synthetic scenes (``_synthetic.build_scene`` at camera radii 2.0 and
2.5, so their poses and scene points differ) sit side by side under one
data dir, their caches under ``cache_<scene>``; one pairs file serves both
(the frame names are the same).  Samples are compared array for array
(both packages are numpy); the training step to the tolerances of
``test_torch_matcher_train.py``.
"""

import random
import shutil

import numpy as np
import pytest
import torch

import jax

from nerfmatch_tpu.config import dict2namespace, save_config

from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from _synthetic import FEAT_DIM, build_scene
from test_torch_matcher_train import (LR, TINY, assert_deltas_match,
                                      assert_samples_equal, jax_c2f_step,
                                      matcher_config)
from test_torch_models import flat_params, t

torch.set_num_threads(2)
SCENES = ["toy_a", "toy_b"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("multiscene")
    for name, radius in zip(SCENES, (2.0, 2.5)):
        built = build_scene(root / f"build_{name}", cam_radius=radius,
                            correlated_feats=True)
        shutil.copytree(built["data_dir"], root / name)
        shutil.copytree(built["cache_dir"], root / f"cache_{name}")
        shutil.copy(built["root"] / "pairs.txt", root / "pairs.txt")
    return dict(root=root, cache_dir=root / "cache_#scene")


# The merged multi-pair layout (NeRFMatchMultiPair, two refs a query, 48
# points drawn from their clouds).
MERGED = {"dataset": "NeRFMatchMultiPair", "sample_mode": "rand",
          "sample_pts": 48}


def multiscene_config(scenes, odir, coarse=False, layout="pair", **data):
    cfg = matcher_config(scenes, odir, coarse=coarse, **data)
    cfg.data.scenes = list(SCENES)
    if layout == "merged":
        for k, v in MERGED.items():
            setattr(cfg.data, k, v)
    return cfg


def seed_all(i):
    """The host draws of a sample: the ``random`` module (pairs) and numpy's
    global generator (the merged layout's refs and points)."""
    random.seed(i)
    np.random.seed(i)


@pytest.mark.parametrize("split,layout", [("train", "pair"), ("val", "pair"),
                                          ("train", "merged")])
def test_concat_dataset_matches_jax(scenes, tmp_path, split, layout):
    """init_multiscene_dataset over two scenes, single pairs or the merged
    multi-pair layout: a ConcatDataset of the same length whose items equal
    the JAX ones (the same seeds before each), the second scene's items
    carrying its own points and poses; the train loader's first batch
    equals the JAX loader's."""
    from nerfmatch_tpu.data.loaders import init_data_loader as jloader
    from nerfmatch_tpu.data.loaders import init_multiscene_dataset as jms

    from nerfmatch_tpu_torch.data.loaders import (ConcatDataset,
                                                  init_data_loader,
                                                  init_multiscene_dataset)

    cfg = multiscene_config(scenes, tmp_path, layout=layout,
                            epoch_sample_num=6, seed=3)
    ours, ref = (init_multiscene_dataset(cfg.data, split=split),
                 jms(cfg.data, split=split))
    assert isinstance(ours, ConcatDataset)
    assert len(ours) == len(ref) and list(ours.offsets) == list(ref.offsets)
    assert len(ours.datasets) == 2
    for i in range(len(ref)):
        seed_all(i)
        a = ours[i]
        seed_all(i)
        assert_samples_equal(a, ref[i])
    first, last = ours[0], ours[len(ours) - 1]
    assert not np.allclose(first["pt3d"], last["pt3d"])
    if split == "train":
        # In the loaders' own thread (num_workers 1) the merged layout's
        # draws from numpy's global generator race the main thread's in
        # both packages: compare the loaders without it.
        seed_all(0)
        got = next(iter(init_data_loader(cfg.data, 2, split="train")))
        seed_all(0)
        want = next(iter(jloader(cfg.data, 0, 2, split="train")))
        assert_samples_equal(got, want)


def test_mixed_dataset_matches_jax(scenes, tmp_path):
    """A mixed config (``data.datasets``: one entry a scene, the second
    with its own ``pair_topk``): init_mixed_dataset's datasets in order and
    their items equal JAX's, and init_data_loader routes the config to it."""
    from nerfmatch_tpu.data.loaders import init_mixed_dataset as jmixed

    from nerfmatch_tpu_torch.data.loaders import (init_data_loader,
                                                  init_mixed_dataset)

    cfg = multiscene_config(scenes, tmp_path, seed=3)
    del cfg.data.scenes
    cfg.data.datasets = dict2namespace({
        "a": {"scenes": [SCENES[0]]},
        "b": {"scenes": [SCENES[1]], "pair_topk": 1}})
    for split in ("train", "test"):
        ours = init_mixed_dataset(cfg.data, split=split, concat=False)
        ref = jmixed(cfg.data, split=split, concat=False)
        assert [len(d) for d in ours] == [len(d) for d in ref]
        assert [d.pair_ids for d in ours] == [d.pair_ids for d in ref]
        for d_ours, d_ref in zip(ours, ref):
            for i in range(0, len(d_ref), 3):
                random.seed(i)
                a = d_ours[i]
                random.seed(i)
                assert_samples_equal(a, d_ref[i])
    loader = init_data_loader(cfg.data, split="test")
    assert len(loader.dataset) == sum(len(d) for d in ref)


@pytest.mark.parametrize("layout", ["pair", "merged"])
def test_mixed_scene_c2f_step_matches_jax(scenes, tmp_path, layout):
    """One C2FTrainStep on a batch of the concatenated dataset whose two
    items come from different scenes (each with its own points, intrinsics
    and GT), single pairs or the merged multi-pair layout, against the JAX
    step (SGD at LR, the JAX step's padded match list): the loss at rtol
    1e-5, every parameter delta within 1e-4 of its leaf's largest with
    cosine > 0.9999."""
    from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JCfg
    from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JMS

    from nerfmatch_tpu_torch.data.loaders import (_collate,
                                                  init_multiscene_dataset)
    from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                        NeRFMatcherMS)
    from nerfmatch_tpu_torch.train.matcher_trainer import (C2F_KEYS,
                                                           C2FTrainStep)

    cfg = multiscene_config(scenes, tmp_path, layout=layout,
                            epoch_sample_num=6, seed=3)
    ds = init_multiscene_dataset(cfg.data, split="train")
    seed_all(0)
    items = [ds[0], ds[int(ds.offsets[1])]]
    assert not np.allclose(items[0]["pt3d"], items[1]["pt3d"])
    batch = {k: np.asarray(v, np.float32)
             for k, v in _collate(items).items() if k in C2F_KEYS}
    mcfg = dict(TINY, pt_dim=FEAT_DIM)
    jm = JMS(JCfg(**mcfg))
    params = jm.init_params(jax.random.PRNGKey(3))
    p2, jmetr, mlist = jax_c2f_step(jm, params, batch)
    tm = NeRFMatcherMS(C2FMatcherConfig(**mcfg))
    tm.load_state_dict(state_dict_from_jax(flat_params(params),
                                           backbone_extra="model."),
                       strict=True)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    step = C2FTrainStep(tm, torch.optim.SGD(tm.parameters(), lr=LR,
                                            momentum=0.0))
    metr = step.step({k: t(v) for k, v in batch.items()}, mlist=mlist)
    np.testing.assert_allclose(float(metr["loss"]), float(jmetr["loss"]),
                               rtol=1e-5)
    assert_deltas_match(tm, before, params, p2, backbone_extra="model.")


def test_cli_train_nerfmatch_over_two_scenes_debug_and_resume(scenes,
                                                              tmp_path):
    """cli.train_nerfmatch --stage c2f --debug with ``scenes: [a, b]``
    trains over the concatenated caches and writes last_1; a second run
    resumes and leaves the weights as they were."""
    from nerfmatch_tpu_torch.cli.train_nerfmatch import main
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import init_config_odir

    cfg = multiscene_config(scenes, tmp_path)
    path = tmp_path / "cfg.yaml"
    save_config(path, cfg)
    argv = ["--config", str(path), "--stage", "c2f", "--debug",
            "--device", "cpu"]
    out_cfg, m1 = main(argv)
    assert "_all_" in init_config_odir(out_cfg, False).as_posix()
    last = latest_checkpoint(init_config_odir(out_cfg, False) / "checkpoints",
                             name="last")
    assert last is not None and last.name == "last_1"
    state = {k: v.clone() for k, v in m1.state_dict().items()}
    _, m2 = main(argv)
    for k, v in m2.state_dict().items():
        assert torch.equal(v, state[k]), k
