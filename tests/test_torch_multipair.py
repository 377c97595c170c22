"""Multi-pair localization and the match oracle of the port against the JAX
package on the CPU, on ``test_torch_benchmark.py``'s 64x64 synthetic scene
(each query with 2 retrieved frames in its pairs file): the
``NeRFMatchMultiPair`` samples in both layouts (stacked: points (K, N, .);
merged: ``sample_mode='rand'``), ``forward_multi_pair`` of both matchers
through ``eval_match`` on exported weights, and ``benchmark_nerfmatch``
with ``--pair_topk 2`` (stacked, and merged with ``--sample_pts 48``) and
with ``--match_oracle``, against the JAX CLI.

Tolerances: the samples array for array (images to 1e-6, the LANCZOS
resize in float); the match lists equal on valid entries, confidences to
1e-4; the CLI's per-query match counts equal and pose errors within the
``--iters 2`` benchmark test's 1e-2 deg and 1e-3.
"""

import random
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.cli import benchmark_nerfmatch as jcli
from nerfmatch_tpu.data import match_dataset as jdata
from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JC2FConfig
from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JNeRFMatcherMS
from nerfmatch_tpu.models.matcher_coarse import (
    CoarseMatcherConfig as JCoarseConfig, NeRFMatcherCoarse as JCoarse)

from nerfmatch_tpu_torch.cli import benchmark_nerfmatch as tcli
from nerfmatch_tpu_torch.data import match_dataset as tdata
from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                    NeRFMatcherMS)
from nerfmatch_tpu_torch.models.matcher_coarse import (CoarseMatcherConfig,
                                                       NeRFMatcherCoarse)
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from _synthetic import H, W
from test_torch_benchmark import bench  # noqa: F401
from test_torch_models import TINY_C2F, flat_params, rnd, t

torch.set_num_threads(2)

LAYOUTS = {"stacked": {}, "merged": {"sample_mode": "rand", "sample_pts": 48}}


def data_config(root, **kw):
    return Namespace(dataset="NeRFMatchMultiPair", data_dir=str(root),
                     scene="toy", scene_dir=str(root / "inter_layer3" / "toy"
                                                / "ds8lin"),
                     train_pair_txt=str(root / "pairs.txt"),
                     test_pair_txt=str(root / "pairs.txt"), pair_topk=2,
                     img_wh=[W, H], model_ds=8, imagenet_norm=False,
                     balanced_pair=False, **kw)


@pytest.mark.parametrize("split", ["test", "train"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_multipair_samples_match_jax(bench, layout, split):
    """Every query's sample under one ``np.random`` (and ``random``) seed:
    the same keys and arrays as the JAX dataset's (points stacked (2, 64, .)
    or merged to 48, the GT conf matrix over all of them, the projected
    points), and a pair file entry per query; on the test split a pair axis
    of 3 cycles the 2 refs, on the train split (the query's own points
    added) the refs are drawn with replacement from ``np.random``."""
    cfg = data_config(bench["root"], **LAYOUTS[layout])
    ours, ref = tdata.NeRFMatchMultiPair(cfg, split), \
        jdata.NeRFMatchMultiPair(cfg, split)
    # The train split leaves one query to the val split.
    assert len(ours) == len(ref) == {"test": 12, "train": 11}[split]
    assert ours.pair_ids == ref.pair_ids
    for side in (ours, ref):
        np.random.seed(0)
        random.seed(0)        # a conf_gt without any match draws one entry
        side.samples = [side[i] for i in range(len(side))]
    for a, b in zip(ours.samples, ref.samples):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], str):
                assert a[k].endswith(b[k].split("/toy/")[-1]), k
            elif k == "image":
                np.testing.assert_allclose(a[k], b[k], atol=1e-6)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n = 48 if layout == "merged" else 2 * 64
        assert a["conf_gt"].shape == (64, n)
        assert a["pt3d"].shape == ((48, 3) if layout == "merged"
                                   else (2, 64, 3))
        assert ("qpt3d" in a) == (split == "train")
    if layout == "stacked" and split == "test":
        cfg.pair_topk = 3
        s = tdata.NeRFMatchMultiPair(cfg, "test")[0]
        assert s["pt3d"].shape == (3, 64, 3)
        np.testing.assert_array_equal(s["pt3d"][2], s["pt3d"][0])


MATCHERS = {
    "c2f": (JNeRFMatcherMS, JC2FConfig, NeRFMatcherMS, C2FMatcherConfig,
            TINY_C2F),
    "coarse": (JCoarse, JCoarseConfig, NeRFMatcherCoarse, CoarseMatcherConfig,
               dict(backbone="tiny", cfeat_dim=32, pt_dim=64, im_sa=3,
                    im_sa_type="share", pt_sa=3, pt_sa_type="full",
                    coarse_layers=1, cformer_type="crs", temp_type="mul")),
}


@pytest.mark.parametrize("kind", list(MATCHERS))
def test_forward_multi_pair_matches_jax(kind):
    """``eval_match`` on points (1, 3, N, .) (``forward_multi_pair``: the
    image branch once, 3 pairs, one of them half masked) against the JAX
    one on exported weights: dense outputs stacked (3, 1, M), the top-k
    lists (3, 1, top_k) equal where valid with confidences to 1e-4, the
    c2f's ``expec_f`` (3, M, 3) to 1e-4; each pair's matches equal the
    single-pair forward's on that pair."""
    JM, JCfg, TM, TCfg, cfg = MATCHERS[kind]
    jm = JM(JCfg(**cfg))
    params = jm.init_params(jax.random.PRNGKey(3))
    img = rnd(30, 1, 128, 128, 3)
    feat, pts = rnd(31, 1, 3, 256, 64), rnd(32, 1, 3, 256, 3, scale=0.3)
    mask = np.ones((1, 3, 256), np.float32)
    mask[0, 1, ::2] = 0.0
    ref = jm.eval_match(params, jnp.asarray(img), jnp.asarray(feat),
                        jnp.asarray(pts), pt_mask=jnp.asarray(mask),
                        mutual=True, top_k=40)
    tm = TM(TCfg(**cfg))
    tm.load_state_dict(state_dict_from_jax(
        flat_params(params),
        **({"backbone_extra": "model."} if kind == "c2f" else {})),
        strict=True)
    ours = tm.eval_match(t(img), t(feat), t(pts), pt_mask=t(mask),
                         mutual=True, top_k=40)
    assert ours["j_ids"].shape == (3, 1, 256)
    assert ours["lists"]["i_ids"].shape == (3, 1, 40)
    v = np.asarray(ref["lists"]["valid"])
    assert v.sum() > 10
    np.testing.assert_array_equal(ours["lists"]["valid"].numpy(), v)
    for k in ("i_ids", "j_ids"):
        np.testing.assert_array_equal(ours["lists"][k].numpy()[v],
                                      np.asarray(ref["lists"][k])[v])
    np.testing.assert_allclose(ours["lists"]["mconf"].numpy(),
                               ref["lists"]["mconf"], atol=1e-4)
    if kind == "c2f":
        assert ours["expec_f"].shape == (3, 256, 3)
        np.testing.assert_allclose(ours["expec_f"].numpy(), ref["expec_f"],
                                   atol=1e-4)
    one = tm.eval_match(t(img), t(feat[:, 1]), t(pts[:, 1]),
                        pt_mask=t(mask[:, 1]), mutual=True, top_k=40)
    for k in ("j_ids", "mconf", "valid"):
        torch.testing.assert_close(ours[k][1], one[k], atol=1e-6, rtol=0)


def test_attention_gate_takes_the_merged_layout():
    """The attention kernel's gate keeps the JAX gate's size rules (a real
    workload, head_dim <= 128) but not its key limit (S <= 8192, the JAX
    kernel's VMEM): the merged layout's 14,400 points reach the kernel, as
    the points' self-attention and the image's queries over them."""
    from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
        fused_attention_available)

    x = lambda n, d=32: torch.empty(1, n, 8, d, device="meta")
    assert fused_attention_available(x(14400), x(14400))
    assert fused_attention_available(x(3600), x(14400))
    assert not fused_attention_available(x(25), x(25))
    assert not fused_attention_available(x(3600, 256), x(3600, 256))


PROTOCOLS = {
    "stacked": (["--pair_topk", "2"], "toy_rth200test_colmap_itr1_top2pt-1.npy"),
    "merged": (["--pair_topk", "2", "--sample_mode", "rand", "--sample_pts",
                "48"], "toy_rth200test_colmap_itr1_top2pt48.npy"),
    # The oracle runs no matcher: on the scene's own point caches (points
    # on a plane the neighbouring frames see), not the NeRF's renders (near
    # the camera, outside the neighbours' views: no GT match).
    "oracle": (["--pair_topk", "2", "--match_oracle", "--scene_dir",
                "{root}/scene_cache"],
               "toy_rth200test_colmap_itr1_top2pt-1.match_oracle.npy"),
}


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_multipair_protocols_match_jax(bench, protocol):
    """``benchmark_nerfmatch --pair_topk 2`` (stacked), the same merged with
    ``--sample_mode rand --sample_pts 48`` and ``--pair_topk 2
    --match_oracle`` (PnP on the GT matches of both refs' points, which sit
    on the projections: errors near 0) on both
    packages, seeded: the result file of the reference's tag name, one row
    per query, the same metric keys, equal match counts and pose errors
    within 1e-2 deg and 1e-3."""
    flags, name = PROTOCOLS[protocol]
    flags = [f.format(root=bench["root"]) for f in flags]
    flags = [*flags, "--mutual", "--rthres", "200", "--seeds", "0",
             "--cache_tag", f"multi_{protocol}"]
    jcli.benchmark(jcli.build_parser().parse_args(
        ["--ckpts", str(bench["ckpts"]["jax"]), *flags]))
    tcli.main(["--ckpts", str(bench["ckpts"]["port"]), "--device", "cpu",
               *flags])
    res_dir = f"multi_{protocol}_best_tmed_run0"
    ref = np.load(bench["root"] / "jax" / res_dir / name,
                  allow_pickle=True).item()
    ours = np.load(bench["root"] / "port" / res_dir / name,
                   allow_pickle=True).item()
    assert set(ours) == set(ref)
    assert len(ours["num_matches"]) == len(ref["num_matches"]) == 12
    np.testing.assert_array_equal(ours["num_matches"], ref["num_matches"])
    assert (np.asarray(ours["num_matches"]) >= 6).all()
    for k, atol in (("R_err", 1e-2), ("t_err", 1e-3)):
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=atol, err_msg=k)
