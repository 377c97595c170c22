"""iNeRF refinement of the port (``nerfmatch_tpu_torch/eval/inerf.py``)
against the JAX package on the CPU, at a small size: a 3-layer hid-32 NeRF
with 16 samples (weights from ``jax.random.PRNGKey(0)``, carried across by
``state_dict_from_jax``), a 32x32 query image from a seed, the tiny c2f
matcher on 32-d points.  On the CPU the step's no-gradient half is the
plain coarse pass, as the JAX iNeRF runs it.

Tolerances: rotation matrices 1e-6; gradients and ray Jacobians 1e-5 of
their largest value; the loss 1e-5 relative; after one Adam step the delta
1e-3 * lrate and Adam's moments 1e-4 relative; after five steps the delta
5e-3 * lrate and the moments 1e-3 of the largest one, because JAX's own f32
gradient drifts: at step 3 of the run without decay it is 1.5e-4 of its
largest component away from an f64 evaluation of the same loss (the
port's: 1.4e-6), and Adam's per-component normalization carries that into
the small components; poses 1e-4; errors 1e-3 deg and 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nerfmatch_tpu.config import dict2namespace
from nerfmatch_tpu.eval import inerf as jinerf
from nerfmatch_tpu.eval.match_evaluator import NeRFMatchEvaluator as JEvaluator
from nerfmatch_tpu.models.matcher_c2f import C2FMatcherConfig as JC2FConfig
from nerfmatch_tpu.models.matcher_c2f import NeRFMatcherMS as JNeRFMatcherMS
from nerfmatch_tpu.nerf.renderer import NerfRenderer as JaxRenderer
from nerfmatch_tpu.utils import geometry as jgeom

from nerfmatch_tpu_torch.eval import inerf
from nerfmatch_tpu_torch.eval.match_evaluator import NeRFMatchEvaluator
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.train.checkpoint import state_dict_from_jax
from nerfmatch_tpu_torch.utils import geometry as tgeom

from _synthetic import look_at
from test_torch_models import TINY_C2F, flat_params

torch.set_num_threads(2)
SIZE = 32
K = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]], np.float32)
C2W_GT = look_at([0.7, 0.1, 0.0]).astype(np.float32)
UNNORM = np.eye(4, dtype=np.float32)
MODEL = dict(TINY_C2F, pt_dim=32)


def perturbed(c2w):
    """``c2w`` turned by (0, 0.06, 0.02) rad and moved by (3, -2, 1) cm in
    its camera frame."""
    pert = np.eye(4)
    pert[:3, :3] = np.asarray(jgeom.rodrigues(jnp.array([0.0, 0.06, 0.02])))
    pert[:3, 3] = [0.03, -0.02, 0.01]
    return c2w @ pert


def nerf_cfg():
    mlp = {"method": "NeRF", "layer_num": 3, "hid_dim": 32, "output_dim": 4,
           "skips": [1], "num_pts": 16}
    return dict2namespace({
        "data": {"img_wh": [SIZE, SIZE]}, "coarse_nerf": mlp,
        "fine_nerf": dict(mlp),
        "embedding": {"xyz_num_freqs": 8, "dirs_num_freqs": 4, "type": "mip"},
        "render": {"chunksize": 4096, "use_viewdirs": True, "use_disp": False,
                   "perturb": True, "white_bg": True, "noise_std": 0.0},
        "loss": {}, "exp": {"seed": 0}})


@pytest.fixture(scope="module")
def pair():
    """Both packages' renderer and evaluator on the same weights, and one
    query batch."""
    jr = JaxRenderer(nerf_cfg())
    params = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 1.0
    tr = NerfRenderer(nerf_cfg())
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    mconf = dict2namespace({"exp": {"seed": 0}, "data": {}, "model": MODEL})
    mparams = JNeRFMatcherMS(JC2FConfig(**MODEL)).init_params(
        jax.random.PRNGKey(1))
    jev = JEvaluator(mconf, params=mparams)
    tev = NeRFMatchEvaluator(mconf, state_dict=state_dict_from_jax(
        flat_params(mparams), backbone_extra="model."), device="cpu")
    ys, xs = np.meshgrid(np.arange(SIZE // 8), np.arange(SIZE // 8),
                         indexing="ij")
    batch = dict(
        image=np.random.default_rng(0).uniform(0, 1, (1, SIZE, SIZE, 3))
        .astype(np.float32),
        K=K[None], c2w=C2W_GT[None], im_mask=np.ones((1, 16), np.float32),
        pt2d=(np.stack([xs, ys], -1).reshape(1, -1, 2) * 8 + 4).astype(
            np.float32))
    return dict(jr=jr, params=params, tr=tr, jev=jev, tev=tev, batch=batch)


def conf(**kw):
    return dict2namespace({"lrate": 0.01, "num_optim": 5, "ds": 2,
                           "lrdecay": False, "eval_pose": True,
                           "use_match_loss": False, **kw})


def jax_steps(p, c, n, init_c2w):
    """``n`` JAX iNeRF steps from ``init_c2w`` -> per step (loss, delta,
    mu, nu) after it, as ``inerf_refinement`` sets the step up."""
    use_match = c.use_match_loss
    step, opt = jinerf._make_step(
        p["jr"], SIZE, SIZE, c.ds, c.num_optim, c.lrate, c.lrdecay, use_match,
        matcher=p["jev"].model if use_match else None)
    img = p["batch"]["image"][0]
    img_ds = jnp.asarray(img[c.ds // 2::c.ds, c.ds // 2::c.ds].reshape(-1, 3))
    rparams = {"params": p["params"], "_K_inv": jnp.asarray(np.linalg.inv(K))}
    ctx = {"unnorm": jnp.asarray(UNNORM)}
    if use_match:
        ctx["mparams"] = p["jev"].params
        ctx["im_cfeat"] = p["jev"].model.extract_im_feat_ms(
            p["jev"].params, jnp.asarray(p["batch"]["image"]))[0]
    init_pose = jnp.asarray(np.linalg.inv(UNNORM) @ init_c2w, jnp.float32)
    delta, state = jnp.zeros(6), opt.init(jnp.zeros(6))
    out = []
    for j in range(n):
        delta, state, loss, _ = step(delta, state, jnp.asarray(j, jnp.float32),
                                     init_pose, rparams, img_ds, ctx)
        out.append((float(loss), np.asarray(delta), np.asarray(state[0].mu),
                    np.asarray(state[0].nu)))
    return out


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.7])
def test_rodrigues_and_its_gradient_match_jax(scale):
    """``rodrigues`` and the gradient of a fixed linear form of it, at the
    zero rotation (finite there) and away from it."""
    rng = np.random.default_rng(3)
    r = (rng.normal(size=3) * scale).astype(np.float32)
    w = rng.normal(size=(3, 3)).astype(np.float32)
    ref = np.asarray(jgeom.rodrigues(jnp.asarray(r)))
    g_ref = np.asarray(jax.grad(
        lambda x: jnp.sum(jgeom.rodrigues(x) * w))(jnp.asarray(r)))
    rt = torch.tensor(r, requires_grad=True)
    R = tgeom.rodrigues(rt)
    g, = torch.autograd.grad(torch.sum(R * torch.from_numpy(w)), rt)
    np.testing.assert_allclose(R.detach().numpy(), ref, atol=1e-6)
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(g.numpy(), g_ref,
                               atol=1e-5 * np.abs(g_ref).max())


@pytest.mark.parametrize("ds", [1, 4])
def test_gen_rays_and_their_jacobian_match_jax(ds):
    """The ds-grid rays at a perturbed delta, and their Jacobian in it."""
    pose = perturbed(C2W_GT).astype(np.float32)
    K_inv = np.linalg.inv(K).astype(np.float32)
    delta = np.array([0.01, -0.02, 0.005, 0.02, 0.01, -0.03], np.float32)

    def jf(d):
        return jinerf._gen_rays_from_pose(jinerf._apply_delta(
            jnp.asarray(pose), d), jnp.asarray(K_inv), SIZE, SIZE, ds)

    def tf(d):
        return inerf._gen_rays_from_pose(inerf._apply_delta(
            torch.from_numpy(pose), d), torch.from_numpy(K_inv), SIZE, SIZE, ds)

    ref = np.asarray(jf(jnp.asarray(delta)))
    np.testing.assert_allclose(tf(torch.from_numpy(delta)).numpy(), ref,
                               atol=1e-5)
    jac_ref = np.asarray(jax.jacfwd(jf)(jnp.asarray(delta)))
    jac = torch.autograd.functional.jacobian(tf, torch.from_numpy(delta))
    np.testing.assert_allclose(jac.numpy(), jac_ref,
                               atol=1e-5 * np.abs(jac_ref).max())


@pytest.fixture(scope="module")
def app_pair(pair):
    """``pair`` with an appearance NeRF: a two-row table on the same MLP
    layout."""
    cfg = nerf_cfg()
    cfg.embedding.appearance_embed = True
    jr = JaxRenderer(cfg, num_frames=2)
    params = jr.init_params(jax.random.PRNGKey(0))
    for k in ("nerf_coarse", "nerf_fine"):
        params[k]["alpha_linear"]["bias"] = params[k]["alpha_linear"]["bias"] + 1.0
    tr = NerfRenderer(cfg, num_frames=2)
    tr.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return dict(pair, jr=jr, params=params, tr=tr)


def check_adam_steps(p, c, moments_atol=1e-3):
    """Five steps at ds 2 from a perturbed pose in both packages: each
    step's loss, and after steps 1 and 5 the delta and Adam's moments
    (after 5 steps within ``moments_atol`` of the largest moment)."""
    start = perturbed(C2W_GT)
    ref = jax_steps(p, c, 5, start)
    q = inerf.InerfQuery(p["tev"], p["batch"], p["tr"], UNNORM, start, c)
    # step: (delta tolerance / lrate, moments rtol, moments atol / largest)
    tols = {0: (1e-3, 1e-4, 0.0), 4: (5e-3, 0.0, moments_atol)}
    for j, (loss_ref, delta_ref, mu, nu) in enumerate(ref):
        loss = q.step(j)[0]
        assert loss == pytest.approx(loss_ref, rel=1e-5), j
        if j in tols:
            d_tol, rtol, atol = tols[j]
            st = q.opt.state[q.delta]
            np.testing.assert_allclose(q.delta.detach().numpy(), delta_ref,
                                       atol=d_tol * c.lrate)
            for got, want in ((st["exp_avg"], mu), (st["exp_avg_sq"], nu)):
                np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                           atol=atol * np.abs(want).max())
    assert len(p["tev"].timer["inerf_step_time"]) >= 5


@pytest.mark.parametrize("lrdecay", [False, True])
def test_adam_steps_match_optax(pair, lrdecay):
    """Five steps at ds 2 from a perturbed pose: each step's loss, and
    after steps 1 and 5 the delta and Adam's moments (optax's mu / nu)."""
    check_adam_steps(pair, conf(lrdecay=lrdecay))


def test_adam_steps_with_appearance_match_jax(app_pair):
    """An appearance NeRF: every query renders with table row 1 (the JAX
    ``_app``), one and five Adam steps as without the table; the row moves
    the loss and takes no gradient.  After five steps the moments are held
    at 2e-3 of the largest: JAX's own f32 run drifts further with the table
    (its moments sit 1.2e-3 of the largest from the port's; in a process
    with 64-bit types enabled, its f32 run sits 6e-6 from the port's and
    the port's 3.6e-6 from the f64 run)."""
    check_adam_steps(app_pair, conf(), moments_atol=2e-3)
    tr = app_pair["tr"]
    assert tr.embedding_a.weight.grad is None
    q = inerf.InerfQuery(app_pair["tev"], app_pair["batch"], tr, UNNORM,
                         perturbed(C2W_GT), conf())
    loss = float(q.loss(q.delta)[0])
    with torch.no_grad():
        tr.embedding_a.weight[1] = tr.embedding_a.weight[0]
    try:
        assert abs(float(q.loss(q.delta)[0]) - loss) > 1e-4 * loss
    finally:
        tr.load_state_dict(state_dict_from_jax(flat_params(
            app_pair["params"])), strict=True)


def test_match_loss_step_matches_jax(pair):
    """``use_match_loss`` at ds 8 (16 rendered points, 16 image tokens): the
    first step's loss and the delta after it, and the loss at JAX's delta
    after that step (the focal term's gradient is ~300 per unit of delta,
    so the two trajectories' later losses are compared at one delta); a ds
    whose rendered count differs from the token count raises."""
    c = conf(ds=8, use_match_loss=True, eval_pose=False)
    start = perturbed(C2W_GT)
    (loss0_ref, delta_ref, _, _), (loss1_ref, _, _, _) = jax_steps(
        pair, c, 2, start)
    q = inerf.InerfQuery(pair["tev"], pair["batch"], pair["tr"], UNNORM,
                         start, c)
    with torch.no_grad():
        photo = float(torch.mean((q.render(q.delta)[0] - q.img_ds) ** 2))
    loss0 = q.step(0)[0]
    assert loss0 == pytest.approx(loss0_ref, rel=1e-5)
    assert loss0 > photo + 0.1                          # the matcher term
    np.testing.assert_allclose(q.delta.detach().numpy(), delta_ref,
                               atol=1e-3 * c.lrate)
    with torch.no_grad():
        loss1 = float(q.loss(torch.tensor(delta_ref))[0])
    assert loss1 == pytest.approx(loss1_ref, rel=1e-5)
    q = inerf.InerfQuery(pair["tev"], pair["batch"], pair["tr"], UNNORM,
                         start, conf(ds=4, use_match_loss=True))
    with pytest.raises(ValueError, match="inerf_ds == model stride 8"):
        q.step(0)


@pytest.mark.parametrize("eval_pose", [True, False])
def test_inerf_refinement_matches_jax(pair, eval_pose):
    """``inerf_refinement`` with ``cache_iters`` (every step evaluated) on the
    pose error and by re-matching + PnP: the refined pose, its errors and
    the per-step error lists; the port runs under ``torch.no_grad()``, as
    ``eval_multi_scenes`` calls it."""
    c = conf(num_optim=4, lrdecay=True, eval_pose=eval_pose)
    start = perturbed(C2W_GT)
    kw = dict(mutual=True, rthres=200.0, cache_iters=True)
    ref_t, ref_r, ours_t, ours_r = [], [], [], []
    c2w_ref, r_ref, t_ref = jinerf.inerf_refinement(
        pair["jev"], pair["batch"], pair["jr"], pair["params"], UNNORM, start,
        c, iter_t_errs=ref_t, iter_R_errs=ref_r, **kw)
    with torch.no_grad():
        c2w, r_err, t_err = inerf.inerf_refinement(
            pair["tev"], pair["batch"], pair["tr"], UNNORM, start, c,
            iter_t_errs=ours_t, iter_R_errs=ours_r, **kw)
    assert len(ours_t) == len(ref_t) == 2
    np.testing.assert_allclose(c2w, c2w_ref, atol=1e-4)
    np.testing.assert_allclose([r_err, *ours_r], [r_ref, *ref_r], atol=1e-3)
    np.testing.assert_allclose([t_err, *ours_t], [t_ref, *ref_t], atol=1e-4)
    if eval_pose:
        r0, t0 = map(float, jgeom.pose_err(jnp.asarray(C2W_GT),
                                           jnp.asarray(start, jnp.float32)))
        assert (r_err, t_err) != (r0, t0)


def test_inerf_overlay_frames_match_jax(pair):
    """``overlay_ims``: one frame a step, each the step's render blended over
    the downsampled query as uint8 (16, 16, 3) at ds 2, within 2/255 of the
    JAX package's frames."""
    c = conf(num_optim=3)
    start = perturbed(C2W_GT)
    ref, ours = [], []
    jinerf.inerf_refinement(pair["jev"], pair["batch"], pair["jr"],
                            pair["params"], UNNORM, start, c,
                            overlay_ims=ref)
    with torch.no_grad():
        inerf.inerf_refinement(pair["tev"], pair["batch"], pair["tr"],
                               UNNORM, start, c, overlay_ims=ours)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.uint8
        assert a.shape == b.shape == (SIZE // 2, SIZE // 2, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
    assert any(not np.array_equal(ours[0], f) for f in ours[1:])


def test_step_moves_the_pose_under_no_grad(pair):
    """A step under an outer ``torch.no_grad()`` still takes its gradient:
    the delta moves and every rendered output is finite."""
    q = inerf.InerfQuery(pair["tev"], pair["batch"], pair["tr"], UNNORM,
                         perturbed(C2W_GT), conf())
    with torch.no_grad():
        loss, pts, feats, rgb = q.step(0)
    assert np.isfinite(loss)
    assert all(bool(torch.isfinite(x).all()) for x in (pts, feats, rgb))
    assert float(q.delta.detach().abs().max()) > 0.5 * q.lrate
