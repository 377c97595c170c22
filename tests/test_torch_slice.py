"""The localization slice end to end: port ``NeRFMatchEvaluator.eval_batch``
(c2f matcher, mutual matches, native PnP, ``iters=2`` re-render) against the
JAX evaluator on the same exported weights and the same seeded inputs, on
the CPU at tiny widths; plus the jax-free import check."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from nerfmatch_tpu.config import dict2namespace
from nerfmatch_tpu.eval.match_evaluator import NeRFMatchEvaluator as JEvaluator
from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JC2FConfig
from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JNeRFMatcherMS
from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer

from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax

from test_torch_models import TINY_C2F, flat_params
from test_torch_nerf import nerf_config

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
H = W = 128
K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)
UNNORM = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)


def look_at(ang, radius=0.6):
    """World-frame c2w (OpenCV axes) on a circle, looking at the origin."""
    eye = np.array([radius * np.cos(ang), 0.1, radius * np.sin(ang)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
    c2w[:3, 3] = eye
    return (np.diag([2.0, 2.0, 2.0, 1.0]) @ c2w).astype(np.float32)


@pytest.fixture(scope="module")
def slice_pair():
    cfg = nerf_config()
    jr = JaxRenderer(cfg, stop_layer=3)
    jr.unnorm_scene = UNNORM
    nparams = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        nparams[k]["alpha_linear"]["bias"] = nparams[k]["alpha_linear"]["bias"] + 3.0
    tr = NerfRenderer(cfg, stop_layer=3)
    tr.load_state_dict(state_dict_from_jax(flat_params(nparams)), strict=True)

    mconf = dict2namespace({"exp": {"seed": 0}, "data": {},
                            "model": dict(TINY_C2F)})
    jm_params = JNeRFMatcherMS(JC2FConfig(**TINY_C2F)).init_params(
        jax.random.PRNGKey(1))
    jev = JEvaluator(mconf, params=jm_params)
    tev = NeRFMatchEvaluator(mconf, state_dict=state_dict_from_jax(
        flat_params(jm_params), backbone_extra="model."), device="cpu")

    rng = np.random.default_rng(20)
    items = []
    for b, ang in enumerate((0.3, 1.9)):
        db = jr.render_novel_view(nparams, (H, W), K, look_at(ang + 0.15),
                                  UNNORM, downsample=8)
        ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
        items.append(dict(
            image=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
            pt3d=np.asarray(db["pt3d"], np.float32),
            pt_feat=np.asarray(db["pt_feat"], np.float32),
            pt_mask=np.ones(256, np.float32), im_mask=np.ones(256, np.float32),
            pt2d=np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32) * 8 + 4,
            K=K, c2w=look_at(ang), unnorm_scene=UNNORM))
    return jr, nparams, tr, jev, tev, items


def collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def matches(ev, batch, b, jax_side):
    """Valid (i, j) pairs and expec_f of batch item ``b`` (first iteration
    inputs), from either evaluator."""
    args = [batch[k] for k in ("image", "pt_feat", "pt3d")]
    if jax_side:
        import jax.numpy as jnp
        out = ev.model.eval_match(
            ev.params, *map(jnp.asarray, args),
            im_mask=jnp.asarray(batch["im_mask"]),
            pt_mask=jnp.asarray(batch["pt_mask"]), mutual=True, top_k=2048)
        out = jax.device_get(out)
    else:
        out = ev._match(batch["image"], batch["pt_feat"], batch["pt3d"],
                        batch["im_mask"], batch["pt_mask"], True, 0.0)
    L = out["lists"]
    v = np.asarray(L["valid"][b])
    pairs = sorted(zip(np.asarray(L["i_ids"][b])[v].tolist(),
                       np.asarray(L["j_ids"][b])[v].tolist()))
    M = np.asarray(out["j_ids"]).shape[1]
    expec = np.asarray(out["expec_f"]).reshape(-1, M, 3)[b]
    return pairs, expec


@pytest.mark.parametrize("bs", [1, 2])
def test_eval_batch_iters2_matches_jax(slice_pair, bs):
    """Identical valid (i_ids, j_ids) sets, expec_f within 1e-4, and per-query
    R/t errors within 1e-2 deg / 1e-3 (PnP on matches that agree to ~1e-6)."""
    jr, nparams, tr, jev, tev, items = slice_pair
    batch = collate(items[:bs])
    for b in range(bs):
        jp, je = matches(jev, batch, b, True)
        tp, te = matches(tev, batch, b, False)
        assert tp == jp and len(tp) >= 4
        np.testing.assert_allclose(te, je, atol=1e-4)
    kw = dict(iters=2, mutual=True, solver="colmap", rthres=200.0)
    ref = jev.eval_batch(batch, renderer=jr, renderer_params=nparams, **kw)
    ours = tev.eval_batch(batch, renderer=tr, **kw)
    assert ours["num_matches"] == ref["num_matches"]
    assert all(c is not None for c in ours["c2w_est"])   # re-render happened
    np.testing.assert_allclose(ours["R_err"], ref["R_err"], atol=1e-2)
    np.testing.assert_allclose(ours["t_err"], ref["t_err"], atol=1e-3)


def test_port_imports_and_runs_without_jax():
    """A fresh interpreter runs the tiny slice (render, match, PnP, iters=2)
    through the port without importing jax or the JAX package."""
    ncfg = {k: vars(v) if hasattr(v, "__dict__") else v
            for k, v in vars(nerf_config()).items()}
    code = f"""
import sys, numpy as np, torch
sys.path.insert(0, {str(ROOT)!r})
torch.set_num_threads(1)
from nerfmatch_tpu_torch.config import dict2namespace
from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
from nerfmatch_tpu_torch.models.layers import init_params_
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
K = np.array({K.tolist()!r}, np.float32)
UN = np.array({UNNORM.tolist()!r}, np.float32)
q, db = np.array({look_at(0.3).tolist()!r}), np.array({look_at(0.45).tolist()!r})
g = torch.Generator().manual_seed(0)
r = init_params_(NerfRenderer(dict2namespace({ncfg!r}), stop_layer=3), g)
ev = NeRFMatchEvaluator(dict2namespace({{'model': {dict(TINY_C2F)!r}}}),
                        generator=g, device='cpu')
pts = r.render_novel_view((128, 128), K, db, UN)
rng = np.random.default_rng(0)
batch = dict(image=rng.uniform(0, 1, (1, 128, 128, 3)),
             pt3d=pts['pt3d'][None], pt_feat=pts['pt_feat'][None],
             pt_mask=np.ones((1, 256)), im_mask=np.ones((1, 256)),
             pt2d=rng.uniform(0, 128, (1, 256, 2)), K=K[None], c2w=q[None],
             unnorm_scene=UN[None])
res = ev.eval_batch(batch, renderer=r, iters=2, rthres=200.0)
assert res['num_matches'][0] > 0, res
assert not any(m.split('.')[0] in ('jax', 'nerfmatch_tpu') for m in sys.modules)
print('OK')
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
