"""Multi-pair matcher training of the port against the JAX trainer on the CPU
(tiny widths, the 12-frame synthetic scene with two retrieved frames a
query): one ``C2FTrainStep`` and one ``CoarseTrainStep`` on a batch of the
merged layout (``NeRFMatchMultiPair`` with ``sample_mode='rand'``, the train
split's refs drawn with replacement), the coarse one also with
``pt_ftype='rand'`` on the JAX step's own draw; the stacked layout, which
neither trainer takes; and ``train_nerfmatch --debug`` with resume on a
merged config with ``--pt_ftype rand``.

Tolerances, as ``test_torch_matcher_train.py``'s: the loss at rtol 1e-5;
every parameter delta of one SGD step within 1e-4 of the leaf's largest
delta with cosine > 0.9999, and a leaf whose JAX delta lies below 1e-5 of
the largest delta of the model (zero in exact arithmetic) below that floor
in the port too.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nerfmatch_tpu.config import save_config

from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax
from nerfmatch_tpu_torch.utils.optim import trainable_parameters

from _synthetic import FEAT_DIM, build_scene
from test_torch_matcher_train import (LR, assert_deltas_match, jax_c2f_step,
                                      matcher_config)
from test_torch_models import flat_params, t

torch.set_num_threads(2)

MERGED = {"sample_mode": "rand", "sample_pts": 48}
MODEL = dict(backbone="tiny", pretrained=False, cfeat_dim=32, pt_dim=FEAT_DIM,
             im_pe=True, im_sa=1, im_sa_type="share", pt_sa=1,
             pt_sa_type="full", pt_pe=True, pt_pe_type="fourier",
             post_pt_pe=True, coarse_layers=1, cformer_type="crs",
             temp_type="mul")
C2F = dict(MODEL, ffeat_dim=16, fine_sa=1, fsa_type="full", win_sz=5,
           cat_c_feat=True, fine_loss="match", coarse_percent=0.3,
           coarse_dthres=20.0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("mp_train_scene"),
                       correlated_feats=True)


def multipair_config(scene, odir, coarse=False, **data):
    cfg = matcher_config(scene, odir, coarse=coarse, **data)
    cfg.data.dataset = "NeRFMatchMultiPair"
    return cfg


@pytest.fixture(scope="module")
def merged_batch(scene, tmp_path_factory):
    """The port loader's first train batch of the merged layout (2 queries,
    48 points each from their two drawn refs), seeded."""
    from nerfmatch_tpu_torch.data.loaders import init_data_loader

    cfg = multipair_config(scene, tmp_path_factory.mktemp("mp"), **MERGED)
    np.random.seed(3)
    random.seed(3)
    batch = next(iter(init_data_loader(cfg.data, 2, split="train")))
    assert batch["pt3d"].shape == (2, 48, 3)
    assert batch["conf_gt"].shape == (2, 64, 48) and batch["conf_gt"].sum() > 4
    return {k: np.asarray(batch[k], np.float32) for k in
            ("image", "pt_feat", "pt3d", "im_mask", "pt_mask", "conf_gt",
             "pt2d", "pt2d_proj")}


def port_model(cls_cfg, params, cfg, **kw):
    model = cls_cfg[0](cls_cfg[1](**cfg))
    model.load_state_dict(state_dict_from_jax(flat_params(params), **kw),
                          strict=True)
    return model


def test_multipair_c2f_step_matches_jax(merged_batch):
    """One C2FTrainStep of each package on the merged batch, the port's
    match list the one the JAX step pads (``jax_c2f_step``): the loss and
    every parameter delta."""
    from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JCfg
    from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JMS

    from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                        NeRFMatcherMS)
    from nerfmatch_tpu_torch.train.matcher_trainer import C2FTrainStep

    jm = JMS(JCfg(**C2F))
    params = jm.init_params(jax.random.PRNGKey(3))
    p2, jmetr, mlist = jax_c2f_step(jm, params, merged_batch)

    tm = port_model((NeRFMatcherMS, C2FMatcherConfig), params, C2F,
                    backbone_extra="model.")
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    step = C2FTrainStep(tm, torch.optim.SGD(trainable_parameters(tm), lr=LR,
                                            momentum=0.0))
    metr = step.step({k: t(v) for k, v in merged_batch.items()}, mlist=mlist)
    for k in ("loss", "coarse_loss", "fine_loss"):
        np.testing.assert_allclose(float(metr[k]), float(jmetr[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(jmetr["fine_loss"]) > 0
    assert_deltas_match(tm, before, params, p2, backbone_extra="model.")


@pytest.mark.parametrize("pt_ftype", ["nerf", "rand"])
def test_multipair_coarse_step_matches_jax(merged_batch, pt_ftype):
    """One CoarseTrainStep of each package on the merged batch: the loss and
    every parameter delta.  ``'rand'``: the port takes the JAX step's draw
    (``jax.random.normal`` of its key) as ``rand_feat``; its own draws come
    from the step's generator, one a step, and inference draws from seed
    0, the same at every call."""
    from nerfmatch_tpu.models.matcher_coarse import CoarseMatcherConfig as JCfg
    from nerfmatch_tpu.models.matcher_coarse import NeRFMatcherCoarse as JC
    from nerfmatch_tpu.train.matcher_trainer import CoarseTrainStep as JStep

    from nerfmatch_tpu_torch.models.matcher_coarse import (
        CoarseMatcherConfig, NeRFMatcherCoarse, rand_point_features)
    from nerfmatch_tpu_torch.train.matcher_trainer import CoarseTrainStep

    cfg = dict(MODEL, pt_ftype=pt_ftype)
    jm = JC(JCfg(**cfg))
    params = jm.init_params(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    opt = optax.sgd(LR)
    p2, _, jmetr = JStep(jm, opt, fused_attention=False).step(
        params, opt.init(params),
        *(jnp.asarray(merged_batch[k]) for k in
          ("image", "pt_feat", "pt3d", "im_mask", "pt_mask", "conf_gt")), key)

    tm = port_model((NeRFMatcherCoarse, CoarseMatcherConfig), params, cfg)
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    step = CoarseTrainStep(tm, torch.optim.SGD(trainable_parameters(tm),
                                               lr=LR, momentum=0.0),
                           generator=gen)
    shape = merged_batch["pt_feat"].shape
    rand_feat = None
    if pt_ftype == "rand":
        rand_feat = t(jax.random.normal(key, shape, jnp.float32))
    batch = {k: t(v) for k, v in merged_batch.items()}
    metr = step.step(batch, rand_feat=rand_feat)
    np.testing.assert_allclose(float(metr["loss"]), float(jmetr["loss"]),
                               rtol=1e-5)
    assert_deltas_match(tm, before, params, p2)
    if pt_ftype == "rand":
        # Without injected features the descriptors are the generator's
        # next (B, N, pt_dim) normal draw.
        state = gen.get_state()
        want = torch.randn(shape, generator=torch.Generator().set_state(state))
        with torch.no_grad():
            drawn = tm.extract_pt_feat(batch["pt_feat"] * 0, batch["pt3d"],
                                       generator=gen)
            injected = tm.extract_pt_feat(batch["pt_feat"] * 0,
                                          batch["pt3d"], rand_feat=want)
        torch.testing.assert_close(drawn, injected, rtol=0, atol=0)
        torch.testing.assert_close(
            rand_point_features(shape[:2], shape[2], "cpu"),
            torch.randn(shape, generator=torch.Generator().manual_seed(0)),
            rtol=0, atol=0)
        with torch.no_grad():
            outs = [tm.forward_match(*(batch[k] for k in
                                       ("image", "pt_feat", "pt3d",
                                        "im_mask", "pt_mask")))
                    for _ in range(2)]
        for k in ("conf_matrix", "j_ids", "mconf"):
            assert torch.equal(outs[0][k], outs[1][k]), k


@pytest.mark.parametrize("stage", ["coarse", "c2f"])
def test_stacked_layout_does_not_train(scene, tmp_path, stage):
    """The stacked layout (no ``sample_mode``: points (B, K, N, .)) fails in
    the JAX trainer's first step (its dual softmax takes 3-d points); the
    port's first step raises a ValueError naming the merged layout's
    settings, on the trainer's batch and on a step called directly."""
    from nerfmatch_tpu.train import matcher_trainer as jtrainer

    from nerfmatch_tpu_torch.models.matcher_coarse import (
        CoarseMatcherConfig, NeRFMatcherCoarse)
    from nerfmatch_tpu_torch.train import matcher_trainer as ttrainer

    coarse = stage == "coarse"
    jcfg = multipair_config(scene, tmp_path / "jax", coarse=coarse)
    with pytest.raises(ValueError):
        (jtrainer.train_coarse if coarse else jtrainer.train_c2f)(jcfg)
    cfg = multipair_config(scene, tmp_path / "port", coarse=coarse)
    with pytest.raises(ValueError, match="sample_mode"):
        (ttrainer.train_coarse if coarse else ttrainer.train_c2f)(
            cfg, device="cpu")
    model = NeRFMatcherCoarse(CoarseMatcherConfig(**MODEL))
    batch = {"image": torch.zeros(1, 64, 64, 3),
             "pt_feat": torch.zeros(1, 2, 64, FEAT_DIM),
             "pt3d": torch.zeros(1, 2, 64, 3),
             "im_mask": torch.ones(1, 64), "pt_mask": torch.ones(1, 2, 64),
             "conf_gt": torch.zeros(1, 64, 128)}
    with pytest.raises(ValueError, match="sample_mode"):
        ttrainer.CoarseTrainStep(model, None).losses(batch)


def test_cli_multipair_rand_debug_and_resume(scene, tmp_path):
    """``train_nerfmatch --stage c2f --debug --update_conf --pt_ftype rand
    --pair_topk 2`` on a merged multi-pair config: checkpoints last_1 and
    best with the val pose metrics; the config trains ``'rand'`` from the
    flag; a second run resumes and leaves the weights as they were."""
    import json

    from nerfmatch_tpu_torch.cli.train_nerfmatch import main
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import init_config_odir

    cfg = multipair_config(scene, tmp_path, **MERGED, epoch_sample_num=4)
    path = tmp_path / "cfg.yaml"
    save_config(path, cfg)
    argv = ["--config", str(path), "--stage", "c2f", "--debug", "--device",
            "cpu", "--update_conf", "--backbone", "tiny", "--pt_dim",
            str(FEAT_DIM), "--pt_sa", "1", "--im_sa", "1", "--cfeat_dim",
            "32", "--pt_pe", "--im_pe", "--pt_ftype", "rand", "--fine_sa",
            "1", "--max_epochs", "1", "--clr", "1e-3", "--cbs", "4",
            "--epoch_sample_num", "4", "--pair_topk", "2",
            "--aug_self_pairs", "0"]
    out_cfg, m1 = main(argv)
    assert out_cfg.model.pt_ftype == "rand" and m1.cfg.pt_ftype == "rand"
    assert out_cfg.data.pair_topk == 2
    ckpts = init_config_odir(out_cfg, False) / "checkpoints"
    last = latest_checkpoint(ckpts, name="last")
    assert last is not None and last.name == "last_1"
    assert latest_checkpoint(ckpts, name="best") is not None
    meta = json.loads((last / "meta.json").read_text())
    assert np.isfinite(meta["best_loss"])
    state = {k: v.clone() for k, v in m1.state_dict().items()}
    _, m2 = main(argv)
    for k, v in m2.state_dict().items():
        assert torch.equal(v, state[k]), k
