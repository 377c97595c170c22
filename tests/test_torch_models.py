"""Port parity: matcher modules, the attention kernel's plain version and the
matching ops against the JAX package on the CPU (tiny widths: the ``tiny``
backbone, cfeat 32, ffeat 16).  Weights cross through the weight bridge;
inputs are seeded numpy.  Tolerance 1e-4 unless stated."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.models import attention as jatt
from nerfmatch_tpu.models import backbone as jbb
from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JC2FConfig
from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JNeRFMatcherMS
from nerfmatch_tpu.models.position_encoding import add_sine_pe as j_add_pe
from nerfmatch_tpu.ops import dsnt as jdsnt
from nerfmatch_tpu.ops import gather as jgather
from nerfmatch_tpu.ops import matching as jmatch
from nerfmatch_tpu.train.checkpoint import export_torch_state_dict

from nerfmatch_tpu_torch.models import attention as tatt
from nerfmatch_tpu_torch.models import backbone as tbb
from nerfmatch_tpu_torch.models.matcher_c2f import C2FMatcherConfig, NeRFMatcherMS
from nerfmatch_tpu_torch.models.position_encoding import add_sine_pe
from nerfmatch_tpu_torch.ops import dsnt as tdsnt
from nerfmatch_tpu_torch.ops import gather as tgather
from nerfmatch_tpu_torch.ops import matching as tmatch
from nerfmatch_tpu_torch.ops.kernels.attention_kernel import attention_plain
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

torch.set_num_threads(2)

TINY_C2F = dict(backbone="tiny", pretrained=False, cfeat_dim=32, ffeat_dim=16,
                pt_dim=64, im_pe=True, im_sa=3, im_sa_type="share", pt_sa=3,
                pt_sa_type="full", pt_pe=True, pt_pe_type="fourier",
                post_pt_pe=True, coarse_layers=1, cformer_type="crs",
                pt_ftype="nerf", fine_sa=1, fsa_type="full", win_sz=5,
                cat_c_feat=True, temp_type="mul")


def flat_params(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in p):
            np.asarray(v) for p, v in flat}


def sub_state(params, name, **kw):
    """Port state dict of a sub-pytree, mapped as it sits under ``name``."""
    sd = state_dict_from_jax(flat_params({name: params}), **kw)
    return {k[len(name) + 1:]: v for k, v in sd.items()}


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True])
def test_attention_plain_matches_pallas_fwd(bf16):
    """Attention kernel's plain version vs _fused_fwd(interpret), ragged L
    and S.  f32: 1e-5.  bf16 mode (bf16 q, k, v and probabilities on both
    sides): mean 1e-6 and max 1e-4, since the two exps break a few bf16
    rounding ties of the probabilities apart (each worth ~4e-3 relative of
    one term)."""
    from nerfmatch_tpu.ops.pallas.attention_kernel import _fused_fwd

    q, k, v = rnd(0, 1, 300, 2, 32, scale=0.2), rnd(1, 1, 200, 2, 32), rnd(2, 1, 200, 2, 32)
    ref = _fused_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_l=128, interpret=True, bf16=bf16)
    err = np.abs(attention_plain(t(q), t(k), t(v), bf16).numpy() - ref)
    if bf16:
        assert err.mean() < 1e-6 and err.max() < 1e-4, (err.mean(), err.max())
    else:
        assert err.max() < 1e-5, err.max()


@pytest.mark.parametrize("mode", ["self_pre", "cross_pre", "self_post"])
def test_encoder_layer_matches(mode):
    att_mode = "cross" if mode.startswith("cross") else "self"
    norm = "post" if mode.endswith("post") else "pre"
    p = jatt.init_encoder_layer(jax.random.PRNGKey(3), model_dim=32,
                                head_num=8, head_dim=4, norm_type=norm,
                                att_mode=att_mode)
    x, c = rnd(4, 2, 20, 32), rnd(5, 2, 13, 32)
    ctx = jnp.asarray(c) if att_mode == "cross" else None
    ref = jatt.encoder_layer_apply(p, jnp.asarray(x), ctx, head_num=8,
                                   norm_type=norm, att_mode=att_mode)
    layer = tatt.EncoderLayer(32, head_num=8, head_dim=4, norm_type=norm,
                              att_mode=att_mode)
    layer.load_state_dict(sub_state(p, "coarse_former"), strict=True)
    with torch.no_grad():
        ours = layer(t(x), t(c) if att_mode == "cross" else None)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_lsa_and_self_cross_blocks_match():
    """LSA self block and the Self/Cross block (``sa`` re-keyed to the
    reference's ``sa.layers``)."""
    p = jatt.init_self_cross_block(jax.random.PRNGKey(6), sa_layer_num=2,
                                   model_dim=32, head_dim=4)
    x1, x2 = rnd(7, 1, 17, 32), rnd(8, 1, 11, 32)
    r1, r2 = jatt.self_cross_block_apply(p, jnp.asarray(x1), jnp.asarray(x2))
    sd = {}
    for k, v in state_dict_from_jax(flat_params(p)).items():
        if k.startswith("sa."):
            k = "sa.layers." + k[3:]
        sd[k] = v
    blk = tatt.SelfCrossBlock(2, 32, 4)
    blk.load_state_dict(sd, strict=True)
    with torch.no_grad():
        o1, o2 = blk(t(x1), t(x2))
    np.testing.assert_allclose(o1.numpy(), r1, atol=1e-4)
    np.testing.assert_allclose(o2.numpy(), r2, atol=1e-4)


@pytest.mark.parametrize("name", ["tiny", "tiny_fpn"])
def test_backbones_match(name):
    """Single-scale trunk and the two-scale MS variant (stem surgery, and
    the FPN for ``*_fpn``) at 1e-4."""
    img = rnd(9, 1, 64, 64, 3)
    if name == "tiny":
        params, cfg = jbb.init_backbone(jax.random.PRNGKey(10), name)
        ref = jbb.backbone_apply(params, cfg, jnp.asarray(img))
        net = tbb.MetaFormer(tbb.make_config(name))
        net.load_state_dict(sub_state(params, "backbone"), strict=True)
        with torch.no_grad():
            ours = net(t(img))[-1]
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
        return
    params, cfg = jbb.init_backbone_8_2(jax.random.PRNGKey(11), name)
    params["fpn"]["layer1_outconv2"]["bn"]["running_var"] = jnp.full((32,), 1.7)
    rc, rf = jbb.backbone_8_2_apply(params, cfg, jnp.asarray(img))
    net = tbb.MetaFormerMS(tbb.make_config(name, two_scale=True))
    net.load_state_dict(sub_state(params, "backbone", backbone_extra="model."),
                        strict=True)
    with torch.no_grad():
        oc, of = net(t(img))
    np.testing.assert_allclose(oc.numpy(), rc, atol=1e-4)
    np.testing.assert_allclose(of.numpy(), rf, atol=1e-4)


def test_matching_ops_match():
    """safe_normalize / masked dual softmax / mutual matches / top-k lists /
    dsnt / row gathers / sine PE at 1e-4; match lists compared as sets."""
    a, b = rnd(12, 2, 40, 16), rnd(13, 2, 30, 16)
    im_mask = np.ones((2, 40), np.float32)
    im_mask[1, 5:9] = 0
    pt_mask = np.ones((2, 30), np.float32)
    pt_mask[0, -3:] = 0
    jc, _, _ = jmatch.dual_softmax(jnp.asarray(a), jnp.asarray(b), 10.0,
                                   jnp.asarray(im_mask), jnp.asarray(pt_mask))
    tc, _, _ = tmatch.dual_softmax(t(a), t(b), torch.tensor(10.0),
                                   t(im_mask), t(pt_mask))
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-4)
    jm = jmatch.extract_mutual_matches(jc, mutual=True)
    tm = tmatch.extract_mutual_matches(tc, mutual=True)
    np.testing.assert_array_equal(tm["valid"].numpy(), jm["valid"])
    v = np.asarray(jm["valid"])
    np.testing.assert_array_equal(tm["j_ids"].numpy()[v], np.asarray(jm["j_ids"])[v])
    jl = jmatch.dense_to_match_lists(jm, 64)
    tl = tmatch.dense_to_match_lists(tm, 64)
    for bi in range(2):
        pick = lambda L: sorted(zip(np.asarray(L["i_ids"])[bi][np.asarray(L["valid"])[bi]],
                                    np.asarray(L["j_ids"])[bi][np.asarray(L["valid"])[bi]]))
        assert pick({k: x.numpy() for k, x in tl.items()}) == pick(jl)
    heat = np.random.default_rng(14).dirichlet(np.ones(25), 6).astype(np.float32)
    heat = heat.reshape(6, 5, 5)
    for x, y in zip(tdsnt.heatmap_expectation_with_std(t(heat)),
                    jdsnt.heatmap_expectation_with_std(jnp.asarray(heat))):
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5)
    table = rnd(15, 3, 7, 5)
    bi, ri = np.array([0, 2, 1, 2], np.int32), np.array([6, 0, 3, 3], np.int32)
    np.testing.assert_array_equal(
        tgather.take_rows_b(t(table), torch.from_numpy(bi), torch.from_numpy(ri)).numpy(),
        jgather.take_rows_b(jnp.asarray(table), jnp.asarray(bi), jnp.asarray(ri)))
    fm = rnd(16, 1, 6, 5, 32)
    np.testing.assert_allclose(add_sine_pe(t(fm)).numpy(), j_add_pe(jnp.asarray(fm)),
                               atol=1e-5)


def test_c2f_matcher_forward_matches():
    """Tiny c2f matcher forward: conf at 1e-4, identical valid/j_ids on
    valid tokens, expec_f at 1e-4."""
    jm = JNeRFMatcherMS(JC2FConfig(**TINY_C2F))
    params = jm.init_params(jax.random.PRNGKey(1))
    img = rnd(17, 1, 128, 128, 3)
    feat, pts = rnd(18, 1, 256, 64), rnd(19, 1, 256, 3, scale=0.3)
    ref = jm.forward_match(params, jnp.asarray(img), jnp.asarray(feat),
                           jnp.asarray(pts), mutual=True)
    tm = NeRFMatcherMS(C2FMatcherConfig(**TINY_C2F))
    tm.load_state_dict(state_dict_from_jax(flat_params(params),
                                           backbone_extra="model."),
                       strict=True)
    with torch.no_grad():
        ours = tm.forward_match(t(img), t(feat), t(pts), mutual=True)
    np.testing.assert_allclose(ours["conf_matrix"].numpy(), ref["conf_matrix"],
                               atol=1e-4)
    v = np.asarray(ref["valid"])
    np.testing.assert_array_equal(ours["valid"].numpy(), v)
    np.testing.assert_array_equal(ours["j_ids"].numpy()[v],
                                  np.asarray(ref["j_ids"])[v])
    np.testing.assert_allclose(ours["expec_f"].numpy(), ref["expec_f"],
                               atol=1e-4)


def test_bridge_production_c2f_keys():
    """Production-dim c2f template: the bridge's keys equal
    export_torch_state_dict(prefix='', backbone_extra='model.') and the port
    module loads them strictly."""
    from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JCfg

    prod = dict(TINY_C2F, backbone="convformer384", cfeat_dim=256,
                ffeat_dim=128, pt_dim=256)
    shapes = jax.eval_shape(JNeRFMatcherMS(JCfg(**prod)).init_params,
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = export_torch_state_dict(params, prefix="", backbone_extra="model.")
    ours = state_dict_from_jax(flat_params(params), backbone_extra="model.")
    assert set(ours) == set(ref)
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
    NeRFMatcherMS(C2FMatcherConfig(**prod)).load_state_dict(ours, strict=True)


def test_coarse_matcher_forward_matches():
    """Tiny Mini (coarse-only) matcher: no attention layers (im_sa 0,
    pt_sa 0, coarse_layers 0); conf at 1e-4, identical matches."""
    from nerfmatch_tpu.models.matcher_coarse import (
        CoarseMatcherConfig as JCoarseConfig, NeRFMatcherCoarse as JCoarse)
    from nerfmatch_tpu_torch.models.matcher_coarse import (
        CoarseMatcherConfig, NeRFMatcherCoarse)

    cfg = dict(backbone="tiny", cfeat_dim=32, pt_dim=64, im_sa=0, pt_sa=0,
               coarse_layers=0, temp_type="div")
    jm = JCoarse(JCoarseConfig(**cfg))
    params = jm.init_params(jax.random.PRNGKey(2))
    img = rnd(20, 1, 64, 64, 3)
    feat, pts = rnd(21, 1, 64, 64), rnd(22, 1, 64, 3, scale=0.3)
    ref = jm.forward_match(params, jnp.asarray(img), jnp.asarray(feat),
                           jnp.asarray(pts), mutual=True)
    tm = NeRFMatcherCoarse(CoarseMatcherConfig(**cfg))
    tm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    with torch.no_grad():
        ours = tm.forward_match(t(img), t(feat), t(pts), mutual=True)
    np.testing.assert_allclose(ours["conf_matrix"].numpy(), ref["conf_matrix"],
                               atol=1e-4)
    v = np.asarray(ref["valid"])
    np.testing.assert_array_equal(ours["valid"].numpy(), v)
    np.testing.assert_array_equal(ours["j_ids"].numpy()[v],
                                  np.asarray(ref["j_ids"])[v])
