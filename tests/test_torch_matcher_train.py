"""Port parity of matcher training against the JAX package on the CPU (tiny
widths): GT padding of the match list, the matcher losses, the matcher
datasets and loader, the loss and every gradient leaf of a c2f training
loss, one coarse train step, the frozen div temperature, the CLI with
resume, the ImageNet init, and the scene-point cache.  Weights cross
through the weight bridge; inputs are seeded numpy."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.config import dict2namespace, save_config
from nerfmatch_tpu.ops import matching as jmatch

from nerfmatch_tpu_torch.ops import matching as tmatch
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax
from nerfmatch_tpu_torch.utils import metrics as tmetrics

from _synthetic import DS, FEAT_DIM, H, W, build_scene
from test_torch_models import flat_params, rnd, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("match_scene"),
                       correlated_feats=True)


# ---------------------------------------------------------------------------
# GT padding
# ---------------------------------------------------------------------------

def jax_pad_draws(key, matches, conf_gt, train_num):
    """The three draws ``nerfmatch_tpu.ops.matching.pad_matches_with_gt``
    makes from ``key`` (its own code, step by step)."""
    B, M, N = conf_gt.shape
    k_pred, k_gt, _ = jax.random.split(key, 3)
    valid_flat = matches["valid"].reshape(-1)
    logits = jnp.where(valid_flat, 0.0, jmatch.NEG_INF)
    logits = jnp.where(jnp.any(valid_flat), logits, jnp.zeros_like(logits))
    pred_pick = jax.random.categorical(k_pred, logits, shape=(train_num,))
    k_row, k_col = jax.random.split(k_gt)
    gt_pos = conf_gt.reshape(B * M, N) > 0
    row_w = jnp.sum(gt_pos, axis=1)
    any_gt = jnp.any(row_w > 0)
    row_logits = jnp.where(row_w > 0, jnp.log(row_w.astype(jnp.float32)),
                           jmatch.NEG_INF)
    row_logits = jnp.where(any_gt, row_logits, jnp.zeros_like(row_logits))
    row_pick = jax.random.categorical(k_row, row_logits, shape=(train_num,))
    col_logits = jnp.where(gt_pos[row_pick], 0.0, jmatch.NEG_INF)
    col_logits = jnp.where(any_gt, col_logits, jnp.zeros_like(col_logits))
    gt_j = jax.random.categorical(k_col, col_logits, axis=-1)
    return {k: np.asarray(v) for k, v in
            dict(pred_pick=pred_pick, row_pick=row_pick, gt_j=gt_j).items()}


def pad_case(seed, no_pred=False, no_gt=False):
    rng = np.random.default_rng(seed)
    B, M, N = 2, 24, 20
    conf = rng.uniform(size=(B, M, N)).astype(np.float32)
    conf_gt = np.zeros((B, M, N), np.float32)
    rows = rng.choice(M, 15, replace=False)
    conf_gt[:, rows, rng.integers(0, N, 15)] = 1.0
    if no_gt:
        conf_gt[:] = 0.0
    jm = jmatch.extract_mutual_matches(jnp.asarray(conf), mutual=True)
    if no_pred:
        jm["valid"] = jnp.zeros_like(jm["valid"])
    tm = {k: torch.from_numpy(np.array(v)) for k, v in jm.items()}
    return conf_gt, jm, tm


@pytest.mark.parametrize("case", ["normal", "no_pred", "no_gt"])
def test_pad_matches_with_gt_matches_jax(case):
    """Same injected draws -> the JAX ids, mconf, is_pred and valid (incl.
    the degenerate no-prediction and no-GT cases); with generator draws:
    the budget sizes, and GT slots land on positives only."""
    conf_gt, jm, tm = pad_case(4, no_pred=case == "no_pred",
                               no_gt=case == "no_gt")
    key = jax.random.PRNGKey(9)
    ref = jmatch.pad_matches_with_gt(key, jm, jnp.asarray(conf_gt),
                                     coarse_percent=0.3, train_percent=0.3)
    train_num, budget = tmatch.pad_match_budgets(*conf_gt.shape)
    assert train_num == len(ref["b_ids"]) == 12 and budget == 3
    draws = jax_pad_draws(key, jm, jnp.asarray(conf_gt), train_num)
    got = tmatch.pad_matches_with_gt(tm, torch.from_numpy(conf_gt),
                                     draws=draws)
    for k in ("b_ids", "i_ids", "j_ids", "mconf", "is_pred", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)

    gen = torch.Generator().manual_seed(0)
    own = tmatch.pad_matches_with_gt(tm, torch.from_numpy(conf_gt),
                                     generator=gen)
    assert all(len(v) == train_num for v in own.values())
    gt = ~own["is_pred"].numpy()
    b, i, j = (own[k].numpy() for k in ("b_ids", "i_ids", "j_ids"))
    if case != "no_gt":
        assert np.all(conf_gt[b[gt], i[gt], j[gt]] == 1.0)
    valid = np.asarray(jm["valid"]).reshape(-1)
    assert np.all(valid[(b * conf_gt.shape[1] + i)[~gt]])
    assert np.array_equal(own["valid"].numpy(),
                          own["is_pred"].numpy() | bool(conf_gt.any()))
    assert own["is_pred"].numpy()[budget:].sum() == 0


# ---------------------------------------------------------------------------
# Losses and pose metrics
# ---------------------------------------------------------------------------

def test_matcher_losses_match_jax():
    """Focal loss (clamped, unclamped, valid-masked), feature l2 and the two
    fine losses (with and without ``valid`` / ``mask`` rows) at rtol 1e-5."""
    from nerfmatch_tpu.utils import metrics as jmetrics

    rng = np.random.default_rng(0)
    conf = rng.uniform(0, 1, (2, 12, 10)).astype(np.float32)
    conf[0, 0, 0] = 0.0
    gt = (rng.uniform(size=(2, 12, 10)) > 0.8).astype(np.float32)
    vm = rng.uniform(size=(2, 12, 10)) > 0.3
    imf, ptf = rnd(1, 2, 12, 8), rnd(2, 2, 10, 8)
    ef = np.concatenate([rnd(3, 30, 2, scale=0.5),
                         rng.uniform(0.05, 1, (30, 1)).astype(np.float32)], -1)
    ef_gt = rnd(4, 30, 2, scale=0.8)
    p_f, p_gt = rnd(5, 30, 2, scale=5), rnd(6, 30, 2, scale=5)
    valid = rng.uniform(size=30) > 0.3
    mask = rng.uniform(size=30) > 0.5
    J, T = jnp.asarray, t
    pairs = [
        (jmetrics.compute_matching_loss(J(conf), J(gt), clamp=True),
         tmetrics.compute_matching_loss(T(conf), T(gt), clamp=True)),
        (jmetrics.compute_matching_loss(J(conf), J(gt), clamp=False,
                                        valid_mask=J(vm)),
         tmetrics.compute_matching_loss(T(conf), T(gt), clamp=False,
                                        valid_mask=torch.from_numpy(vm))),
        (jmetrics.compute_feat_l2(J(imf), J(ptf), J(gt)),
         tmetrics.compute_feat_l2(T(imf), T(ptf), T(gt))),
        (jmetrics.compute_fine_loss_l2_std(J(ef), J(ef_gt)),
         tmetrics.compute_fine_loss_l2_std(T(ef), T(ef_gt))),
        (jmetrics.compute_fine_loss_l2_std(J(ef), J(ef_gt), valid=J(valid)),
         tmetrics.compute_fine_loss_l2_std(T(ef), T(ef_gt),
                                           valid=torch.from_numpy(valid))),
        (jmetrics.compute_fine_match_loss_l2_std(J(p_f), J(p_gt), J(ef[:, 2])),
         tmetrics.compute_fine_match_loss_l2_std(T(p_f), T(p_gt), T(ef[:, 2]))),
        (jmetrics.compute_fine_match_loss_l2_std(
            J(p_f), J(p_gt), J(ef[:, 2]), mask=J(mask), valid=J(valid)),
         tmetrics.compute_fine_match_loss_l2_std(
             T(p_f), T(p_gt), T(ef[:, 2]), mask=torch.from_numpy(mask),
             valid=torch.from_numpy(valid))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_pose_metrics_match_jax():
    """Host PnP pose metrics on exact correspondences plus outliers: the
    same errors and counts as the JAX package (1e-4)."""
    from nerfmatch_tpu.utils import metrics as jmetrics

    rng = np.random.default_rng(2)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.2, -2.0]
    pts = rng.uniform(-1, 1, (60, 3))
    cam = pts - c2w[:3, 3]
    pix = (cam / cam[:, 2:]) @ K.T
    pix[:6] += 30.0
    items = [{"pt2d": pix[:, :2], "pt3d": pts, "K": K, "c2w_gt": c2w}]
    ref = jmetrics.compute_pose_metrics_host(items, rthres=2.0)
    got = tmetrics.compute_pose_metrics_host(items, rthres=2.0)
    for k in ("num_matches", "num_inls"):
        assert got[k] == ref[k]
    np.testing.assert_allclose(got["R_err"] + got["t_err"],
                               ref["R_err"] + ref["t_err"], atol=1e-4)


# ---------------------------------------------------------------------------
# Datasets and loader
# ---------------------------------------------------------------------------

def matcher_config(scene, odir, coarse=True, **data):
    model = {"backbone": "tiny", "pretrained": False, "cfeat_dim": 32,
             "pt_dim": FEAT_DIM, "im_pe": True, "im_sa": 0, "im_sa_type": None,
             "pt_sa": 0, "pt_sa_type": None, "pt_pe": False, "coarse_layers": 0,
             "temp_type": "mul", "rthres": 6}
    if not coarse:
        model.update({"ffeat_dim": 16, "fine_sa": 1, "fsa_type": "full",
                      "win_sz": 5, "cat_c_feat": True, "fine_loss": "match",
                      "coarse_percent": 0.3, "coarse_dthres": 20})
    return dict2namespace({
        "data": {"dataset": "NeRFMatchPair", "data_dir": str(scene["root"]),
                 "scenes": ["toy"], "scene_dir": str(scene["cache_dir"]),
                 "train_pair_txt": str(scene["root"] / "pairs.txt"),
                 "test_pair_txt": str(scene["root"] / "pairs.txt"),
                 "pair_topk": 2, "img_wh": [W, H], "model_ds": DS,
                 "imagenet_norm": False, "balanced_pair": False, **data},
        "model": model,
        "optim": {"optimizer": "adam", "adapt_lr": True, "clr": 1e-3,
                  "cbs": 4, "weight_decay": 0.0, "lr_scheduler": "cosine",
                  "coarse_only_epochs": 0 if coarse else 1},
        "exp": {"seed": 2, "odir": str(odir), "prefix": "t", "num_workers": 1,
                "max_epochs": 1, "check_epochs": 1, "batch_size": 2,
                "gpus": 1, "debug": True},
    })


def assert_samples_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=1e-6,
                                       err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("split,data", [
    ("train", {"epoch_sample_num": 4, "aug_self_pairs": 1, "seed": 7}),
    ("val", {"balanced_pair": True, "imagenet_norm": True})])
def test_match_pair_dataset_matches_jax(scene, tmp_path, split, data):
    """NeRFMatchPair on the synthetic scene: the same pair ids and, for the
    same seed, the same samples (every key, incl. conf_gt and pt2d_proj);
    the train loader's first prefetched batch equals the JAX loader's."""
    from nerfmatch_tpu.data.loaders import init_data_loader as jloader
    from nerfmatch_tpu.data.match_dataset import NeRFMatchPair as JPair

    from nerfmatch_tpu_torch.data.loaders import init_data_loader
    from nerfmatch_tpu_torch.data.match_dataset import NeRFMatchPair

    cfg = matcher_config(scene, tmp_path, **data)
    cfg.data.scene = "toy"
    ours, ref = NeRFMatchPair(cfg.data, split=split), JPair(cfg.data, split=split)
    assert ours.pair_ids == ref.pair_ids and len(ours) == len(ref)
    for i in range(len(ref)):
        random.seed(i)
        a = ours[i]
        random.seed(i)
        assert_samples_equal(a, ref[i])
    if split == "train":
        del cfg.data.scene
        got = next(iter(init_data_loader(cfg.data, 2, split="train",
                                         num_workers=1)))
        want = next(iter(jloader(cfg.data, 1, 2, split="train")))
        assert_samples_equal(got, want)


def test_prefetch_loader_keeps_order_and_raises_dataset_errors():
    """The thread-prefetch loader yields the batches in order and re-raises
    a dataset error in the consumer."""
    from nerfmatch_tpu_torch.data.loaders import DataLoader

    class Samples:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad sample")
            return {"x": np.full(2, i)}

    it = iter(DataLoader(Samples(), batch_size=2, num_workers=1))
    assert [next(it)["x"][:, 0].tolist() for _ in range(2)] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="bad sample"):
        next(it)


# ---------------------------------------------------------------------------
# c2f training loss and gradients
# ---------------------------------------------------------------------------

TINY = dict(backbone="tiny", pretrained=False, cfeat_dim=32, ffeat_dim=16,
            pt_dim=24, im_pe=True, im_sa=1, im_sa_type="share", pt_sa=1,
            pt_sa_type="full", pt_pe=True, pt_pe_type="fourier",
            post_pt_pe=True, coarse_layers=1, cformer_type="crs",
            pt_ftype="nerf", fine_sa=1, fsa_type="full", win_sz=5,
            cat_c_feat=True, temp_type="mul", coarse_percent=0.3,
            coarse_dthres=20.0)


def c2f_batch(seed=0):
    rng = np.random.default_rng(seed)
    B, N = 2, 64
    M = (64 // 8) ** 2
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    pt2d = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32) * 8 + 4
    conf_gt = np.zeros((B, M, N), np.float32)
    for b in range(B):
        conf_gt[b, rng.choice(M, 40, replace=False), rng.choice(N, 40, replace=False)] = 1
    return {"image": rnd(seed + 1, B, 64, 64, 3),
            "pt_feat": rnd(seed + 2, B, N, 24),
            "pt3d": rnd(seed + 3, B, N, 3, scale=0.3),
            "im_mask": np.ones((B, M), np.float32),
            "pt_mask": (rng.uniform(size=(B, N)) > 0.1).astype(np.float32),
            "conf_gt": conf_gt,
            "pt2d": np.broadcast_to(pt2d, (B, M, 2)).copy(),
            "pt2d_proj": rng.uniform(0, 64, (B, N, 2)).astype(np.float32)}


def jax_c2f_loss(model, p, batch, mlist, coarse_only):
    """The JAX c2f train loss as ``C2FTrainStep.body`` composes it, with the
    match list injected."""
    from nerfmatch_tpu.train.matcher_trainer import coarse_losses
    from nerfmatch_tpu.utils import metrics as jmetrics

    cfg = model.cfg
    im_cfeat, fmap_f = model.extract_im_feat_ms(p, batch["image"])
    pt_cfeat = model.extract_pt_feat(p, batch["pt_feat"], batch["pt3d"])
    im_cfeat, pt_cfeat = model.apply_coarse_former(p, im_cfeat, pt_cfeat)
    conf, im_n, pt_n = jmatch.dual_softmax(
        im_cfeat, pt_cfeat, model.temperature(p), batch["im_mask"],
        batch["pt_mask"], temp_type=cfg.temp_type)
    coarse_loss, _ = coarse_losses(conf, batch["conf_gt"], im_n, pt_n,
                                   clamp=True)
    b, i, j = mlist["b_ids"], mlist["i_ids"], mlist["j_ids"]
    expec_f = model.forward_fine(p, fmap_f, im_cfeat, pt_cfeat, b, i, j)
    mpt2d_c = batch["pt2d"][b, i]
    mpt2d_f_gt = batch["pt2d_proj"][b, j]
    coarse_pos = jnp.linalg.norm(mpt2d_f_gt - mpt2d_c, axis=-1) < cfg.coarse_dthres
    if cfg.fine_loss == "match":
        fine = jmetrics.compute_fine_match_loss_l2_std(
            model.fine_coords(expec_f, mpt2d_c), mpt2d_f_gt, expec_f[:, 2],
            mask=coarse_pos, valid=mlist["valid"])
    else:
        radius = cfg.fine_ds * cfg.win_sz // 2
        fine = jmetrics.compute_fine_loss_l2_std(
            expec_f, (mpt2d_f_gt - mpt2d_c) / radius, valid=mlist["valid"])
    return jnp.where(coarse_only, coarse_loss, coarse_loss + fine)


@pytest.mark.parametrize("fine_loss,coarse_only", [("match", False),
                                                   ("exp", False),
                                                   ("match", True)])
def test_c2f_loss_and_grads_match_jax(fine_loss, coarse_only):
    """The port's C2FTrainStep.losses vs jax.value_and_grad of the same loss
    on the same weights, inputs and match list: loss at rtol 1e-5; every
    gradient leaf within 1e-4 of the leaf's largest gradient, cosine >
    0.9999.  Leaves whose gradient is zero in exact arithmetic (the
    discarded fine merge; the fine stage under coarse_only; biases the
    window softmax is invariant to, whose JAX gradient is f32 noise below
    1e-5 of the largest gradient of the model) must stay below that floor
    in the port too, or be absent."""
    from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JCfg
    from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JMS

    from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                        NeRFMatcherMS)
    from nerfmatch_tpu_torch.train.matcher_trainer import C2FTrainStep

    cfg = dict(TINY, fine_loss=fine_loss)
    jm = JMS(JCfg(**cfg))
    params = jm.init_params(jax.random.PRNGKey(3))
    batch = c2f_batch()
    rng = np.random.default_rng(11)
    L = 40
    mlist = {"b_ids": rng.integers(0, 2, L).astype(np.int32),
             "i_ids": rng.integers(0, 64, L).astype(np.int32),
             "j_ids": rng.integers(0, 64, L).astype(np.int32),
             "valid": rng.uniform(size=L) > 0.2}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl = {k: jnp.asarray(v) for k, v in mlist.items()}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_c2f_loss(jm, p, jb, jl, coarse_only)))(params)

    tm = NeRFMatcherMS(C2FMatcherConfig(**cfg))
    tm.load_state_dict(state_dict_from_jax(flat_params(params),
                                           backbone_extra="model."),
                       strict=True)
    step = C2FTrainStep(tm, opt=None)
    loss, _ = step.losses({k: t(v) for k, v in batch.items()},
                          coarse_only=coarse_only,
                          mlist={k: torch.from_numpy(v) for k, v in mlist.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    want = state_dict_from_jax(flat_params(ref_grads), backbone_extra="model.")
    got = dict(tm.named_parameters())
    assert set(got) <= set(want)
    floor = 1e-5 * max(float(v.abs().max()) for v in want.values())
    for k, ref in want.items():
        g = got[k].grad if k in got and got[k].grad is not None \
            else torch.zeros_like(ref)
        scale = float(ref.abs().max())
        if scale <= floor:
            assert float(g.abs().max()) <= floor, k
            continue
        cos = float((g * ref).sum()) / float(g.norm() * ref.norm())
        assert float((g - ref).abs().max()) <= 1e-4 * scale and cos > 0.9999, \
            (k, float((g - ref).abs().max()) / scale, cos)


def coarse_model_pair(temp_type="mul"):
    from nerfmatch_tpu.models.matcher_coarse import CoarseMatcherConfig as JCfg
    from nerfmatch_tpu.models.matcher_coarse import NeRFMatcherCoarse as JC

    from nerfmatch_tpu_torch.models.matcher_coarse import (CoarseMatcherConfig,
                                                           NeRFMatcherCoarse)

    cfg = dict(backbone="tiny", pretrained=False, cfeat_dim=32, pt_dim=16,
               im_pe=True, im_sa=0, im_sa_type=None, pt_sa=0, pt_sa_type=None,
               pt_pe=False, coarse_layers=0, temp_type=temp_type)
    jm = JC(JCfg(**cfg))
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = NeRFMatcherCoarse(CoarseMatcherConfig(**cfg))
    tm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    rng = np.random.default_rng(1)
    bs, hw, n = 2, 32, 16
    m = (hw // 8) ** 2
    conf_gt = np.zeros((bs, m, n), np.float32)
    conf_gt[:, np.arange(m), rng.integers(0, n, m)] = 1.0
    batch = {"image": rng.uniform(0, 1, (bs, hw, hw, 3)).astype(np.float32),
             "pt_feat": rng.normal(size=(bs, n, 16)).astype(np.float32),
             "pt3d": rng.normal(size=(bs, n, 3)).astype(np.float32),
             "im_mask": np.ones((bs, m), np.float32),
             "pt_mask": np.ones((bs, n), np.float32), "conf_gt": conf_gt}
    return jm, params, tm, batch


def test_coarse_train_step_matches_jax():
    """One CoarseTrainStep of each package with SGD at lr 1, momentum 0:
    the parameter deltas are the gradients; each within 1e-4 of the leaf's
    largest delta, cosine > 0.9999, and the same loss."""
    import optax

    from nerfmatch_tpu.train.matcher_trainer import CoarseTrainStep as JStep

    from nerfmatch_tpu_torch.train.matcher_trainer import CoarseTrainStep
    from nerfmatch_tpu_torch.utils.optim import trainable_parameters

    jm, params, tm, batch = coarse_model_pair()
    opt = optax.sgd(1.0)
    jstep = JStep(jm, opt, fused_attention=False)
    p2, _, jmetr = jstep.step(params, opt.init(params),
                              *(jnp.asarray(batch[k]) for k in batch),
                              jax.random.PRNGKey(5))
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    step = CoarseTrainStep(tm, torch.optim.SGD(trainable_parameters(tm),
                                               lr=1.0, momentum=0.0))
    metr = step.step({k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metr["loss"]), float(jmetr["loss"]),
                               rtol=1e-5)
    before_j, after_j = flat_params(params), flat_params(p2)
    want = state_dict_from_jax(
        {k: np.asarray(after_j[k] - before_j[k]) for k in before_j})
    for k, p in tm.named_parameters():
        d, ref = p.detach() - before[k], want[k]
        scale = float(ref.abs().max())
        if scale == 0.0:
            assert float(d.abs().max()) == 0.0, k
            continue
        cos = float((d * ref).sum()) / float(d.norm() * ref.norm())
        assert float((d - ref).abs().max()) <= 1e-4 * scale and cos > 0.9999, k


def test_div_temperature_frozen_through_port_train_step():
    """The div (LoFTR) temperature does not train: it is not a trainable
    parameter, and an Adam step leaves it at 0.1 while the rest moves."""
    from nerfmatch_tpu_torch.train.matcher_trainer import CoarseTrainStep
    from nerfmatch_tpu_torch.utils.optim import trainable_parameters

    _, _, tm, batch = coarse_model_pair(temp_type="div")
    assert not tm.temperature.requires_grad
    assert all(p is not tm.temperature for p in trainable_parameters(tm))
    w0 = tm.backbone.stem.conv.weight.detach().clone()
    step = CoarseTrainStep(tm, torch.optim.Adam(trainable_parameters(tm),
                                                lr=1e-2))
    step.step({k: t(v) for k, v in batch.items()})
    assert float(tm.temperature) == pytest.approx(0.1)
    assert not torch.allclose(tm.backbone.stem.conv.weight, w0)


# ---------------------------------------------------------------------------
# Training loop, CLI, ImageNet init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["coarse", "c2f"])
def test_cli_train_nerfmatch_debug_and_resume(scene, tmp_path, stage):
    """cli.train_nerfmatch --debug on the synthetic scene writes last_1
    (and best) checkpoints with best_loss / best_tmed; a second run resumes
    and leaves the weights as they were; the LR is clr * batch / cbs.  The
    coarse run starts from a synthetic timm file (ImageNet init)."""
    from nerfmatch_tpu_torch.cli.train_nerfmatch import main
    from nerfmatch_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import (build_matcher,
                                                           init_config_odir)

    cfg = matcher_config(scene, tmp_path, coarse=stage == "coarse")
    if stage == "coarse":
        tmpl = build_matcher(cfg, True, torch.Generator().manual_seed(2))
        npz = tmp_path / "timm.npz"
        np.savez(npz, **{k.replace("stages_", "stages."): v.numpy() + 3.0
                         for k, v in tmpl.backbone.state_dict().items()})
        cfg.model.pretrained = True
        cfg.model.timm_ckpt = str(npz)
    path = tmp_path / "cfg.yaml"
    save_config(path, cfg)
    out_cfg, m1 = main(["--config", str(path), "--stage", stage, "--debug",
                        "--device", "cpu"])
    assert out_cfg.optim.lr == pytest.approx(1e-3 * 2 / 4)
    ckpts = init_config_odir(out_cfg, stage == "coarse") / "checkpoints"
    last = latest_checkpoint(ckpts, name="last")
    assert last is not None and last.name == "last_1"
    assert latest_checkpoint(ckpts, name="best") is not None
    import json
    meta = json.loads((last / "meta.json").read_text())
    assert {"best_loss", "best_tmed"} <= set(meta)
    state = {k: v.clone() for k, v in m1.state_dict().items()}
    _, m2 = main(["--config", str(path), "--stage", stage, "--debug",
                  "--device", "cpu"])
    for k, v in m2.state_dict().items():
        assert torch.equal(v, state[k]), k
    if stage == "coarse":
        bias = m1.backbone.stem.conv.bias.detach()
        init = tmpl.backbone.stem.conv.bias.detach()
        assert torch.all((bias - (init + 3.0)).abs() < 0.5)


def test_imagenet_init_from_jax_format_timm_file(tmp_path):
    """A raw-timm .npz written from JAX backbone params (the JAX test's own
    helper) lands in the port's trunk (every tensor = JAX leaf + 1); a
    configured file that is missing raises; an absent default warns and the
    weights stay as they were."""
    import logging

    from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JCfg
    from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JMS
    from test_trainers import _synthetic_timm_npz

    from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                        NeRFMatcherMS)
    from nerfmatch_tpu_torch.train import matcher_trainer as mt

    jparams = JMS(JCfg(**TINY)).init_params(jax.random.PRNGKey(0))
    trunk = {k: v for k, v in jparams["backbone"].items() if k != "fpn"}
    npz = tmp_path / "timm.npz"
    _synthetic_timm_npz(trunk, npz, shift=1.0)
    tm = NeRFMatcherMS(C2FMatcherConfig(**TINY))
    conf = dict2namespace({"backbone": "tiny", "pretrained": True,
                           "timm_ckpt": str(npz)})
    assert mt.init_imagenet_backbone(tm, conf) == len(
        tm.backbone.model.state_dict())
    want = state_dict_from_jax(flat_params({"backbone": trunk}))
    for k, v in tm.backbone.model.state_dict().items():
        torch.testing.assert_close(v, want["backbone." + k] + 1.0, atol=1e-6,
                                   rtol=0)
    conf.timm_ckpt = str(tmp_path / "nope.pth")
    with pytest.raises(FileNotFoundError):
        mt.init_imagenet_backbone(tm, conf)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    mt.logger.addHandler(handler)
    try:
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        assert mt.init_imagenet_backbone(tm, dict2namespace(
            {"backbone": "tiny", "pretrained": True})) == 0
    finally:
        mt.logger.removeHandler(handler)
    assert any("FROM SCRATCH" in m for m in records), records
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())


def test_matcher_warm_starts(tmp_path):
    """load_pretrained, as the JAX _load_pretrained: a reference two-scale
    checkpoint and a coarse one (backbone -> backbone.model) warm-start the
    c2f matcher; a port coarse checkpoint directory grafts its shared
    tensors, backbone included, and the fine stage stays at init."""
    from nerfmatch_tpu_torch.models.layers import init_params_
    from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                        NeRFMatcherMS)
    from nerfmatch_tpu_torch.models.matcher_coarse import (CoarseMatcherConfig,
                                                           NeRFMatcherCoarse)
    from nerfmatch_tpu_torch.train.checkpoint import save_checkpoint
    from nerfmatch_tpu_torch.train.matcher_trainer import load_pretrained

    kw = dict(backbone="tiny", pretrained=False, cfeat_dim=32, pt_dim=16,
              im_pe=True, im_sa=1, im_sa_type="share", pt_sa=0,
              pt_sa_type=None, pt_pe=False, coarse_layers=1)
    ms = init_params_(NeRFMatcherMS(C2FMatcherConfig(
        **kw, ffeat_dim=16, fine_sa=1, fsa_type="full", win_sz=5,
        cat_c_feat=True)), torch.Generator().manual_seed(0))
    stem = ms.backbone.model.stem.conv.weight
    w = torch.randn(stem.shape)
    for name, key, scale, conf in (
            ("ms.ckpt", "model.backbone.model.stem.conv.weight", 1.0,
             "c2f_ckpt"),
            ("coarse.ckpt", "model.backbone.stem.conv.weight", 2.0,
             "coarse_ckpt")):
        torch.save({"state_dict": {"model.temperature": torch.tensor(scale),
                                   key: w * scale}}, tmp_path / name)
        assert load_pretrained(ms, dict2namespace(
            {conf: str(tmp_path / name)})) == 2
        assert float(ms.temperature) == scale and torch.equal(stem, w * scale)

    coarse = init_params_(NeRFMatcherCoarse(CoarseMatcherConfig(**kw)),
                          torch.Generator().manual_seed(7))
    save_checkpoint(tmp_path / "ckpts", 3, coarse, name="best")
    fine = {k: v.clone() for k, v in ms.state_dict().items()
            if k.startswith("fine")}
    load_pretrained(ms, dict2namespace(
        {"coarse_ckpt": str(tmp_path / "ckpts" / "best_3")}))
    assert torch.equal(stem, coarse.backbone.stem.conv.weight)
    assert torch.equal(ms.temperature, coarse.temperature)
    assert all(torch.equal(ms.state_dict()[k], v) for k, v in fine.items())
    with pytest.raises(FileNotFoundError):
        load_pretrained(ms, dict2namespace({"c2f_ckpt": str(tmp_path / "no")}))


# ---------------------------------------------------------------------------
# Scene-point cache
# ---------------------------------------------------------------------------

def test_cache_scene_pts_matches_jax(scene, tmp_path):
    """The port's NerfEvaluator.cache_scene_pts on the CPU writes the schema
    load_frame_3d reads, with pt3d and pt_feat within 1e-4 of the JAX cache
    (trunk_int8='none') of the same tiny NeRF on the same frames."""
    from nerfmatch_tpu.eval.nerf_evaluator import NerfEvaluator as JEval
    from nerfmatch_tpu.nerf.renderer import NerfRenderer as JRenderer

    from nerfmatch_tpu_torch.data.loading import load_frame_3d
    from nerfmatch_tpu_torch.eval.nerf_evaluator import NerfEvaluator
    from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
    from test_torch_nerf import nerf_config

    cfg = nerf_config(hid=32)
    cfg.data = dict2namespace({
        "dataset": "NerfBaseDataset", "data_dir": str(scene["root"]),
        "scene": "toy", "img_wh": [W, H], "ray_type": "mip",
        "max_frustum_depth": 1, "rescale_factor": 1.0, "snorm_type": "fst",
        "downsample": 8})
    cfg.exp = dict2namespace({"seed": 0})
    cfg.downsample = 8
    cfg.coarse_nerf.num_pts = cfg.fine_nerf.num_pts = 32
    jr = JRenderer(cfg, stop_layer=3)
    params = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 3.0
    jdir = JEval(cfg, jr, params).cache_scene_pts(
        cache_dir=tmp_path / "jax", trunk_int8="none")
    tr = NerfRenderer(cfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    tdir = NerfEvaluator(cfg, tr).cache_scene_pts(cache_dir=tmp_path / "port")
    assert tdir.name == jdir.name == "ds8lin"
    for frame in scene["frames"]:
        ours = load_frame_3d(frame, tdir, return_pose=True)
        ref = load_frame_3d(frame, jdir, return_pose=True)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, atol=1e-4)
        keys = set(np.load(tdir / f"{frame['file_path'].replace('/', '_').replace('.color', '').replace('.png', '')}.npy",
                           allow_pickle=True).item())
        assert keys == {"pt3d", "unnorm_scene", "pt_feat", "pt_color",
                        "cam2scene"}
