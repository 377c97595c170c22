"""The reference protocol on the port's own Lightning checkpoints, and the
``coarse_ckpt`` warm start, against the JAX package on the CPU.

The port trains a NeRF (hid 32, 32 + 32 samples), Mini and Full for 15
debug steps each on the enclosed synthetic scene and writes the three
Lightning checkpoints (``e2e.parity_artifacts.make_artifacts``).  The JAX CLIs
(``eval_nerf``, ``benchmark_nerfmatch``: the files through
``convert_torch_params``) and the port's CLIs then run the protocol's steps
2-5 on copies of the same files."""

import shutil

import numpy as np
import pytest
import torch

import jax

from nerfmatch_tpu.cli import benchmark_nerfmatch as jbench
from nerfmatch_tpu.cli import eval_nerf as jeval
from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JC2FConfig
from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JNeRFMatcherMS
from nerfmatch_tpu.models.matcher_coarse import \
    CoarseMatcherConfig as JCoarseConfig
from nerfmatch_tpu.models.matcher_coarse import \
    NeRFMatcherCoarse as JNeRFMatcherCoarse
from nerfmatch_tpu.ops import matching as jmatch
from nerfmatch_tpu.train import checkpoint as jckpt
from nerfmatch_tpu.train.matcher_trainer import _load_pretrained

from nerfmatch_tpu_torch.data.loaders import _collate
from nerfmatch_tpu_torch.data.match_dataset import NeRFMatchPair
from nerfmatch_tpu_torch.e2e import parity_artifacts as pa
from nerfmatch_tpu_torch.e2e import pipeline
from nerfmatch_tpu_torch.models.matcher_c2f import (C2FMatcherConfig,
                                                    NeRFMatcherMS)
from nerfmatch_tpu_torch.train.checkpoint import (load_reference_checkpoint,
                                                  state_dict_from_jax)
from nerfmatch_tpu_torch.train.matcher_trainer import (BATCH_KEYS,
                                                       coarse_features,
                                                       load_pretrained)

from test_torch_models import flat_params

torch.set_num_threads(2)
HID = 32
NERF_EDITS = {"coarse_nerf.hid_dim": HID, "fine_nerf.hid_dim": HID,
              "coarse_nerf.num_pts": 32, "fine_nerf.num_pts": 32,
              "exp.batch_size": 1024, "exp.debug": True, "exp.num_workers": 0}
MATCH_EDITS = {"model.pt_dim": HID, "exp.debug": True, "exp.num_workers": 0}
# Debug epochs of 5 steps: enough that both models match and PnP solves
# most queries (the comparison below is then not vacuous).
NERF_EPOCHS, MATCH_EPOCHS = 3, 3
PSNR_WH, PSNR_FRAMES = (32, 32), 2
CLAMP = 1e-6                     # the c2f focal loss's clamp


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The port's artifacts, its protocol run, and the JAX CLIs' run of the
    same steps on a copy of the checkpoints (separate output dirs)."""
    root = tmp_path_factory.mktemp("parity")
    made = pa.make_artifacts(root, NERF_EPOCHS, MATCH_EPOCHS, "cpu",
                             NERF_EDITS, MATCH_EDITS)
    paths = pa.artifact_paths(root)
    port = pa.protocol_steps(root, paths, "cpu", img_wh=PSNR_WH,
                             psnr_frames=PSNR_FRAMES)
    jroot = root / "jax"
    shutil.copytree(root / "pretrained", jroot / "pretrained")
    jpaths = pa.artifact_paths(jroot)
    argv = pa.protocol_argv(root, jpaths, out=jroot / "outputs",
                            img_wh=PSNR_WH, psnr_frames=PSNR_FRAMES)
    mp = pytest.MonkeyPatch()
    mp.setenv("NERFMATCH_COMPILE_CACHE", "0")
    try:
        jax_psnr = jeval.main(argv["psnr"])["psnr"]
        jeval.main(argv["cache"])
        jbench.main(argv["mini"])
        jbench.main(argv["full"])
    finally:
        mp.undo()
    return dict(root=root, made=made, paths=paths, port=port, jroot=jroot,
                jpaths=jpaths, jax_psnr=jax_psnr)


def test_lightning_checkpoints_have_the_reference_layout(art):
    """``model.``-prefixed reference keys (Full's trunk under
    ``backbone.model.``), the training config as ``hyper_parameters``, and
    Full warm-started from Mini's ``best`` checkpoint."""
    nerf, hp = load_reference_checkpoint(art["paths"]["nerf"])
    assert hp["coarse_nerf"].hid_dim == HID and "nerf_fine.alpha_linear.weight" in nerf
    mini, _ = load_reference_checkpoint(art["paths"]["mini"])
    full, fhp = load_reference_checkpoint(art["paths"]["full"])
    assert any(k.startswith("backbone.stages_") for k in mini)
    assert any(k.startswith("backbone.model.stages_") for k in full)
    assert fhp["model"].coarse_ckpt == art["made"]["warm_start"]["ckpt"]
    assert "/checkpoints/best_" in fhp["model"].coarse_ckpt
    assert art["made"]["warm_start"]["tensors"] > 0


def test_protocol_psnr_and_cache_match_jax(art):
    """Step 2: per-frame PSNR within 1e-3 dB; step 3: every frame's cached
    pt3d within 1e-4 and pt_feat within 1e-4 of its largest value (f32
    renders of the same weights, the plain path on both sides)."""
    port, out = art["port"], art["root"] / "outputs"
    jpsnr = np.asarray(art["jax_psnr"], np.float64)
    assert port["psnr_frames"] == len(jpsnr) == PSNR_FRAMES
    assert port["psnr"] == pytest.approx(float(jpsnr.mean()), abs=1e-3)
    sub = "scene_pts/inter_layer3/toy/ds8lin"
    ours = sorted((out / sub).glob("*.npy"))
    assert len(ours) == 30
    for f in ours:
        a = np.load(f, allow_pickle=True).item()
        b = np.load(art["jroot"] / "outputs" / sub / f.name,
                    allow_pickle=True).item()
        np.testing.assert_allclose(a["pt3d"], b["pt3d"], atol=1e-4)
        scale = max(float(np.abs(b["pt_feat"]).max()), 1e-6)
        np.testing.assert_allclose(a["pt_feat"] / scale,
                                   b["pt_feat"] / scale, atol=1e-4)


@pytest.mark.parametrize("model", ["mini", "full"])
def test_protocol_benchmark_matches_jax(art, model):
    """Steps 4 and 5: per query the same match count, failed PnPs in the
    same places, and pose errors within 1e-2 deg / 1e-3 (PnP on the same
    matches of renders that agree to float rounding).  Every query has
    matches and at least half have a finite pose, so the poses are
    compared."""
    port = art["port"][model]
    ref = pa.bench_results(art["jpaths"]["match_dir"], model)
    assert len(port["num_matches"]) == 6
    np.testing.assert_array_equal(port["num_matches"], ref["num_matches"])
    assert min(ref["num_matches"]) > 0, ref["num_matches"]
    assert np.isfinite(np.asarray(ref["R_err"], np.float64)).sum() >= 3, ref
    for k, atol in (("R_err", 1e-2), ("t_err", 1e-3)):
        a, b = np.asarray(port[k]), np.asarray(ref[k], np.float64)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)],
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# coarse_ckpt warm start
# ---------------------------------------------------------------------------

def jax_conf(jm, p, batch):
    """The JAX c2f step's coarse conf matrix (``C2FTrainStep.body``)."""
    im_cfeat, _ = jm.extract_im_feat_ms(p, batch["image"])
    pt_cfeat = jm.extract_pt_feat(p, batch["pt_feat"], batch["pt3d"])
    im_cfeat, pt_cfeat = jm.apply_coarse_former(p, im_cfeat, pt_cfeat)
    return jmatch.dual_softmax(im_cfeat, pt_cfeat, jm.temperature(p),
                               batch["im_mask"], batch["pt_mask"],
                               temp_type=jm.cfg.temp_type)[0]


@pytest.mark.parametrize("route", ["native", "lightning"])
def test_coarse_ckpt_warm_start_matches_jax(art, tmp_path, route):
    """One trained Mini grafted into the same c2f init by both packages'
    ``coarse_ckpt`` loaders gives the same c2f initial state (every tensor
    equal) and, on one training batch of the scene, the same coarse conf
    (within 1e-6) and the same share of GT positives above the focal loss's
    clamp.  ``native``: each package's own checkpoint directory of the
    weights (the pipelines' route: the port's ``best`` dir, an orbax dir
    for JAX); ``lightning``: one reference ``.ckpt`` for both."""
    best = art["made"]["warm_start"]["ckpt"]
    ccfg = pipeline.apply_edits(pipeline.matcher_cfg(
        art["root"], art["made"]["train_cache"], tmp_path, c2f=True),
        MATCH_EDITS)
    model_kw = dict(vars(ccfg.model))
    mini = {k: v.float() for k, v in torch.load(
        f"{best}/model.pt", map_location="cpu", weights_only=True).items()}
    if route == "native":
        template = JNeRFMatcherCoarse(JCoarseConfig(**{
            k: v for k, v in model_kw.items()
            if k in JCoarseConfig.__dataclass_fields__})).init_params(
                jax.random.PRNGKey(0))
        jmini, missing = jckpt.convert_torch_params(
            template, {k: v.numpy() for k, v in mini.items()})
        assert not missing
        jdir = jckpt.save_checkpoint(tmp_path / "jax_best", 1, jmini,
                                     name="best")
        port_ckpt, jax_ckpt = best, str(jdir)
    else:
        port_ckpt = jax_ckpt = str(tmp_path / "mini.ckpt")
        torch.save({"state_dict": {"model." + k: v for k, v in mini.items()},
                    "hyper_parameters": {}}, port_ckpt)

    jm = JNeRFMatcherMS(JC2FConfig(**{
        k: v for k, v in model_kw.items()
        if k in JC2FConfig.__dataclass_fields__}))
    init = jm.init_params(jax.random.PRNGKey(3))
    tm = NeRFMatcherMS(C2FMatcherConfig.from_namespace(ccfg.model))
    tm.load_state_dict(state_dict_from_jax(flat_params(init),
                                           backbone_extra="model."),
                       strict=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    jconf = pipeline.apply_edits(pipeline.matcher_cfg(
        art["root"], art["made"]["train_cache"], tmp_path, c2f=True),
        MATCH_EDITS).model
    jconf.coarse_ckpt = jax_ckpt
    ccfg.model.coarse_ckpt = port_ckpt
    jp = _load_pretrained(jm, init, jconf)
    n = load_pretrained(tm, ccfg.model)
    want = {k: torch.as_tensor(v) for k, v in jckpt.export_torch_state_dict(
        jp, prefix="", backbone_extra="model.").items()}
    got = tm.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    moved = [k for k in got if not torch.equal(got[k], before[k])]
    assert n >= len(moved) > 0
    assert any(k.startswith("backbone.model.") for k in moved)
    assert not any(k.startswith("fine") for k in moved)

    ds = NeRFMatchPair(ccfg.data, split="train")
    batch = _collate([ds[0], ds[1]])
    tb = {k: torch.as_tensor(np.asarray(batch[k], np.float32))
          for k in BATCH_KEYS}
    with torch.no_grad():
        conf = coarse_features(tm.eval(), *(tb[k] for k in BATCH_KEYS[:5]))[0]
    jc = np.asarray(jax_conf(jm, jp, {k: jax.numpy.asarray(v)
                                      for k, v in tb.items()}))
    np.testing.assert_allclose(conf.numpy(), jc, atol=1e-6)
    pos = batch["conf_gt"] > 0
    share = float((conf.numpy()[pos] > CLAMP).mean())
    assert pos.sum() > 0
    assert share == float((jc[pos] > CLAMP).mean())
