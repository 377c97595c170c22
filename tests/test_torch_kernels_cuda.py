"""Card-only tests: each CUDA kernel of the port against its plain PyTorch
version on the same inputs.  Marked ``cuda``; they skip without a GPU.
This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfmatch_tpu.config import dict2namespace
from nerfmatch_tpu_torch.models.layers import init_params_
from nerfmatch_tpu_torch.nerf.renderer import NerfRenderer
from nerfmatch_tpu_torch.ops import kernels
from nerfmatch_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (
    attention_bwd, attention_bwd_plain, attention_plain, fused_attention)
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (render_stage,
                                                           render_stage_plain)
from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
    StageSpec, render_train, render_train_plain)
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (resample_z,
                                                             resample_z_plain)
from nerfmatch_tpu_torch.ops.kernels.sepconv_kernel import (
    dw_star, dw_star_dgrad, dw_star_dgrad_plain, dw_star_fwd, dw_star_plain,
    dw_star_wgrad, dw_star_wgrad_plain)
from nerfmatch_tpu_torch.nerf.model import NerfConfig, NerfMLP


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def renderer(hid, dev):
    nerf = {"method": "NeRF", "layer_num": 8, "hid_dim": hid, "output_dim": 4,
            "skips": [4], "num_pts": 128}
    cfg = dict2namespace({
        "render": {"use_viewdirs": True, "white_bg": False},
        "embedding": {"xyz_num_freqs": 15, "dirs_num_freqs": 4, "type": "mip"},
        "coarse_nerf": nerf, "fine_nerf": nerf})
    r = init_params_(NerfRenderer(cfg, stop_layer=3),
                     torch.Generator().manual_seed(0))
    with torch.no_grad():
        r.nerf_fine.alpha_linear.bias += 3.0      # partly opaque field
    return r.to(dev).eval()


def rays_z(n, dev, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.05), np.full((n, 1), 1.4),
                           d, np.full((n, 1), 0.002)], -1).astype(np.float32)
    rays = torch.from_numpy(rays).to(dev)
    t = torch.linspace(0, 1, 129, device=dev)
    z = (rays[:, 6:7] * (1 - t) + rays[:, 7:8] * t).contiguous()
    return rays, z


@pytest.mark.cuda
@pytest.mark.parametrize("hid,eps", [(256, 0.0), (256, 1e-4), (64, 1e-4)])
def test_render_kernel_matches_plain(dev, hid, eps):
    """Coarse and fine variants against the plain version with the same
    bf16 MLP operands at atol/rtol 5e-3 (f32 accumulation order, and bf16
    rounding ties that the two sides break apart), and against the f32-MLP
    plain version at 2e-2 (the JAX fused-vs-XLA tolerance; features
    relative to their largest value)."""
    r = renderer(hid, dev)
    rays, z = rays_z(64, dev)
    reset_launch_counts()
    kw = dict(num_freqs=15, dirs_freqs=4, early_term_eps=eps)
    with torch.no_grad():
        for fine in (False, True):
            a = render_stage(r.nerf_fine, rays, z, fine=fine, **kw)
            b = render_stage_plain(r.nerf_fine, rays, z, fine=fine, **kw)
            c = render_stage_plain(r.nerf_fine, rays, z, fine=fine,
                                   trunk_bf16=False, **kw)
            for k in b:
                torch.testing.assert_close(a[k], b[k], atol=5e-3, rtol=5e-3)
                scale = float(c[k].abs().max()) if k == "feat" else 1.0
                assert float((a[k] - c[k]).abs().max()) <= 2e-2 * scale, k
    assert LAUNCHES["render_coarse"] == LAUNCHES["render_fine"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 256])
@pytest.mark.parametrize("mode", ["coarse", "both", "posttap"])
def test_int8_render_kernel_matches_plain(dev, hid, mode):
    """The int8 trunk's stages of ``mode`` against the plain int8 version
    with the same scales (calibrated from these rays): outputs at atol/rtol
    5e-3 (the bf16 layers and heads, as above, and compositing order), and
    fewer than 1e-3 of the integer activations (the quantized encoding and
    the last layer's int8 input) one step apart (sinf / expf against
    torch's, and the bf16 prefix's f32 sums, at a rounding boundary); the
    launch counters of the int8 stages move."""
    from nerfmatch_tpu_torch.nerf.model import eval_feat_layer
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_mlp_int8)

    r = renderer(hid, dev)
    rays, z = rays_z(64, dev)
    scales = calibrate_act_scales(r, rays)
    tap = eval_feat_layer(r.nerf_fine.cfg)
    stages = [(r.nerf_coarse, False, pack_mlp_int8(r.nerf_coarse,
                                                   scales["coarse"], 0))]
    if mode != "coarse":
        start = 0 if mode == "both" else tap + 1
        stages.append((r.nerf_fine, True, pack_mlp_int8(
            r.nerf_fine, scales["fine"], start, tap)))
    reset_launch_counts()
    kw = dict(num_freqs=15, dirs_freqs=4, debug_q=True)
    with torch.no_grad():
        for mlp, fine, q in stages:
            a = render_stage(mlp, rays, z, fine=fine, int8=q, **kw)
            b = render_stage_plain(mlp, rays, z, fine=fine, int8=q, **kw)
            for k in ("xq", "hq"):
                assert float((a[k] != b[k]).float().mean()) < 1e-3, k
            for k in b:
                if k not in ("xq", "hq"):
                    torch.testing.assert_close(a[k], b[k], atol=5e-3,
                                               rtol=5e-3)
    assert LAUNCHES["render_coarse_int8"] == 1
    assert LAUNCHES["render_fine_int8"] == (mode != "coarse")
    assert LAUNCHES["render_coarse"] == LAUNCHES["render_fine"] == 0


@pytest.mark.cuda
def test_int8_render_kernel_raises_on_unsupported(dev):
    """A width without an instantiation, and a fine stage packed without
    its tap layer, raise instead of running plain."""
    from nerfmatch_tpu_torch.ops.kernels.quant import (calibrate_act_scales,
                                                       pack_mlp_int8)

    wide = renderer(128, dev)
    rays, z = rays_z(64, dev)
    scales = calibrate_act_scales(wide, rays)
    with pytest.raises(NotImplementedError), torch.no_grad():
        render_stage(wide.nerf_coarse, rays, z, fine=False, num_freqs=15,
                     dirs_freqs=4,
                     int8=pack_mlp_int8(wide.nerf_coarse, scales["coarse"]))
    r = renderer(256, dev)
    scales = calibrate_act_scales(r, rays)
    with pytest.raises(ValueError), torch.no_grad():
        render_stage(r.nerf_fine, rays, z, fine=True, num_freqs=15,
                     dirs_freqs=4,
                     int8=pack_mlp_int8(r.nerf_fine, scales["fine"]))


@pytest.mark.cuda
def test_resample_kernel_matches_plain(dev):
    """Inverse-CDF resample at atol 1e-5, including an all-zero row."""
    rays, z = rays_z(256, dev)
    w = torch.rand(256, 128, device=dev, generator=torch.Generator(dev).manual_seed(0))
    w[3] = 0.0
    torch.testing.assert_close(resample_z(z, w), resample_z_plain(z, w),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_resample_kernel_stratified_u_matches_plain(dev):
    """The training mode: the caller's stratified u, atol 1e-5."""
    from nerfmatch_tpu_torch.nerf.sampling import stratified_u
    rays, z = rays_z(256, dev)
    g = torch.Generator(dev).manual_seed(1)
    w = torch.rand(256, 128, device=dev, generator=g)
    u = stratified_u(256, 129, g, dev)
    torch.testing.assert_close(resample_z(z, w, u=u),
                               resample_z_plain(z, w, u=u), atol=1e-5, rtol=0)


def train_stage(hid, dev, n=64, S=128, seed=0):
    cfg = NerfConfig(layer_num=8, hid_dim=hid, xyz_dim=90, dirs_dim=27,
                     use_viewdirs=True, skips=(4,))
    mlp = init_params_(NerfMLP(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        mlp.alpha_linear.bias += 1.0
    mlp = mlp.to(dev)
    rays, _ = rays_z(n, dev, seed)
    g = torch.Generator(dev).manual_seed(seed)
    t = torch.linspace(0, 1, S + 1, device=dev)
    z = rays[:, 6:7] * (1 - t) + rays[:, 7:8] * t
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lo, hi = torch.cat([z[:, :1], mids], 1), torch.cat([mids, z[:, -1:]], 1)
    z = (lo + (hi - lo) * torch.rand(z.shape, device=dev, generator=g)).contiguous()
    noise = torch.randn(n, S, device=dev, generator=g)
    target = torch.rand(n, 3, device=dev, generator=g)
    return StageSpec(mlp, 15, 4), rays, z, noise, target


def stage_grads(fn, spec, rays, z, noise, target):
    spec.mlp.zero_grad()
    rgb, w = fn(spec, rays, z, noise)
    loss = ((rgb - target) ** 2).mean() + 0.1 * (w ** 2).mean()
    loss.backward()
    return rgb.detach(), w.detach(), {k: p.grad.clone() for k, p in
                                      spec.mlp.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("hid", [64, 256])
def test_render_train_kernels_match_plain(dev, hid):
    """Train forward (rgb, weights) at atol 5e-3 against the plain version
    with the same bf16 operands; backward per parameter: cosine > 0.999,
    norm ratio 1 +- 1e-2 and max error <= 3e-2 of the leaf's largest
    gradient (f32 sums in another order; the gradients are rounded to bf16
    on both sides); both launch counters move."""
    spec, rays, z, noise, target = train_stage(hid, dev)
    reset_launch_counts()
    a_rgb, a_w, a_g = stage_grads(render_train, spec, rays, z, noise, target)
    b_rgb, b_w, b_g = stage_grads(render_train_plain, spec, rays, z, noise,
                                  target)
    assert LAUNCHES["render_train_fwd"] == LAUNCHES["render_train_bwd"] == 1
    torch.testing.assert_close(a_rgb, b_rgb, atol=5e-3, rtol=0)
    torch.testing.assert_close(a_w, b_w, atol=5e-3, rtol=0)
    for k, ref in b_g.items():
        got = a_g[k]
        assert torch.isfinite(got).all(), k
        nr = float(ref.norm())
        if nr < 1e-9:
            continue
        cos = float((got * ref).sum()) / (float(got.norm()) * nr)
        ratio = float(got.norm()) / nr
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert cos > 0.999 and abs(ratio - 1) < 1e-2 and err < 3e-2, \
            (k, cos, ratio, err)


@pytest.mark.cuda
def test_render_train_kernels_are_deterministic(dev):
    """Two backward runs give bit-identical gradients (no atomics)."""
    spec, rays, z, noise, target = train_stage(256, dev, seed=3)
    _, _, g1 = stage_grads(render_train, spec, rays, z, noise, target)
    _, _, g2 = stage_grads(render_train, spec, rays, z, noise, target)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


@pytest.mark.cuda
def test_train_kernel_raises_on_unported_configs(dev):
    """Appearance embeddings, uninstantiated widths, odd ray counts and
    sample counts off the 64-row chunk raise instead of running plain."""
    spec, rays, z, noise, _ = train_stage(64, dev, n=4, S=64)
    app = NerfMLP(NerfConfig(layer_num=8, hid_dim=64, xyz_dim=90, dirs_dim=27,
                             app_dim=16, use_viewdirs=True)).to(dev)
    wide = NerfMLP(NerfConfig(layer_num=8, hid_dim=128, xyz_dim=90,
                              dirs_dim=27, use_viewdirs=True)).to(dev)
    for bad in (StageSpec(app, 15, 4), StageSpec(wide, 15, 4)):
        with pytest.raises(NotImplementedError):
            render_train(bad, rays, z, noise)
    with pytest.raises(NotImplementedError):
        render_train(spec, rays[:3], z[:3], noise[:3])
    with pytest.raises(NotImplementedError):
        render_train(spec, rays, z[:, :33].contiguous(),
                     noise[:, :32].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_attention_kernel_matches_plain(dev, bf16):
    """Ragged L, S.  f32: atol 1e-4.  bf16 mode (the same bf16 operands and
    probabilities on both sides): mean 1e-5 and max 1e-3, since the two
    exps and summation orders break a few bf16 rounding ties of the
    probabilities apart."""
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(2, 333, 8, 32, device=dev, generator=g) * 0.3
    k = torch.randn(2, 517, 8, 32, device=dev, generator=g)
    v = torch.randn(2, 517, 8, 32, device=dev, generator=g)
    with torch.no_grad():
        err = (fused_attention(q, k, v, bf16)
               - attention_plain(q, k, v, bf16)).abs()
    if bf16:
        assert float(err.mean()) < 1e-5 and float(err.max()) < 1e-3
    else:
        assert float(err.max()) < 1e-4


@pytest.mark.cuda
def test_kernels_raise_instead_of_falling_back(dev):
    """Unsupported shapes and gradient requests raise on CUDA tensors."""
    r = renderer(256, dev)
    rays, z = rays_z(3, dev)
    with pytest.raises(NotImplementedError):
        render_stage(r.nerf_fine, rays, z, fine=True, num_freqs=15,
                     dirs_freqs=4)
    q = torch.randn(1, 300, 2, 16, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError):
        fused_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError):
        attention_bwd(q.detach(), q.detach(), q.detach(), q.detach())
    one = torch.ones((), device=dev)
    # 96 channels (not a multiple of 128), then a 5 x 5 filter (7 x 7 only).
    for C, K in ((96, 7), (128, 5)):
        x = torch.randn(1, 16, 16, C, device=dev)
        w = torch.randn(K, K, C, device=dev)
        for fn in (lambda: dw_star(x, w, w[0, 0], one, one),
                   lambda: dw_star_dgrad(x, w, one, x),
                   lambda: dw_star_wgrad(x, one, one, x, K=K)):
            with pytest.raises(NotImplementedError):
                fn()


def sepconv_inputs(dev, B, H, W, C, K=7, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(B, H, W, C, device=dev, generator=g)
    w = torch.randn(K, K, C, device=dev, generator=g) * 0.1
    cb = torch.randn(C, device=dev, generator=g)
    s = torch.tensor(0.9, device=dev)
    b = torch.tensor(-0.4, device=dev)
    up = torch.randn(B, H, W, C, device=dev, generator=g)
    return x, w, cb, s, b, up


def scaled_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 17, 9, 128), (2, 60, 60, 512),
                                   (2, 240, 240, 256)])
def test_dw_star_kernels_match_plain(dev, shape):
    """Forward, dgrad and wgrad against the plain versions (f32, TF32 off):
    y, dx and dw within 1e-4 of their largest value, ds and db within 1e-5
    of the sum of the absolute terms (f32 sums in another order)."""
    x, w, cb, s, b, g = sepconv_inputs(dev, *shape)
    reset_launch_counts()
    assert scaled_err(dw_star_fwd(x, w, cb, s, b),
                      dw_star_plain(x, w, cb, s, b)) < 1e-4
    dx, ds, db = dw_star_dgrad(x, w, s, g)
    dxp, dsp, dbp = dw_star_dgrad_plain(x, w, s, g)
    assert scaled_err(dx, dxp) < 1e-4
    wf = torch.flip(w, (0, 1)).permute(2, 0, 1).unsqueeze(1)
    dact = torch.nn.functional.conv2d(g.permute(0, 3, 1, 2), wf, padding=3,
                                      groups=shape[-1])
    r = torch.relu(x).permute(0, 3, 1, 2)
    assert abs(float(ds - dsp)) < 1e-5 * float((dact * r * r).abs().sum())
    assert abs(float(db - dbp)) < 1e-5 * float(dact.abs().sum())
    assert scaled_err(dw_star_wgrad(x, s, b, g),
                      dw_star_wgrad_plain(x, s, b, g)) < 1e-4
    assert LAUNCHES["dw_star_fwd"] == LAUNCHES["dw_star_dgrad"] == \
        LAUNCHES["dw_star_wgrad"] == 1


@pytest.mark.cuda
def test_dw_star_autograd_matches_plain_and_is_deterministic(dev):
    """All five gradients of dw_star against autograd of the plain version,
    and two backward runs bit-identical (no atomics)."""
    x, w, cb, s, b, g = sepconv_inputs(dev, 2, 30, 30, 256, seed=2)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, w, cb, s, b)]
        (fn(*ins) * g).sum().backward()
        return [t.grad for t in ins]

    a1, a2, ref = grads(dw_star), grads(dw_star), grads(dw_star_plain)
    for got, again, want in zip(a1, a2, ref):
        assert torch.equal(got, again)
        assert scaled_err(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(2, 333, 517, 8), (2, 3600, 3600, 8)])
def test_attention_bwd_kernel_matches_plain(dev, bf16, shape):
    """dq, dk, dv against the plain backward with the same roundings.  f32:
    1e-4 of each output's largest value; bf16 (bf16 operands, z and dl on
    both sides; rounding ties of z and dl broken apart by other summation
    orders): 1e-2 of the largest value and cosine > 0.999.  Two runs are
    bit-identical, and the autograd Function reaches the kernel."""
    B, L, S, H = shape
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(B, L, H, 32, device=dev, generator=g) * 0.3
    k = torch.randn(B, S, H, 32, device=dev, generator=g)
    v = torch.randn(B, S, H, 32, device=dev, generator=g)
    up = torch.randn(B, L, H, 32, device=dev, generator=g)
    reset_launch_counts()
    with torch.no_grad():
        got = attention_bwd(q, k, v, up, bf16)
        again = attention_bwd(q, k, v, up, bf16)
        ref = attention_bwd_plain(q, k, v, up, bf16)
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)
        cos = float((a * r).sum()) / float(a.norm() * r.norm())
        assert scaled_err(a, r) < (1e-2 if bf16 else 1e-4) and cos > 0.999
    qq = q.clone().requires_grad_()
    (fused_attention(qq, k, v, bf16) * up).sum().backward()
    assert torch.equal(qq.grad, got[0])
    assert LAUNCHES["attention_bwd"] == 3 and LAUNCHES["attention"] == 1


def test_ctypes_signatures_match_c_entry_points():
    """The ctypes argtypes table agrees with every ``extern "C"`` entry of
    csrc/*.cu, argument by argument (runs without a GPU)."""
    ctype = {"void*": kernels._P, "int": kernels._I, "float": kernels._F}
    found = {}
    for src in kernels.CSRC.glob("*.cu"):
        text = Path(src).read_text()
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for arg in args.split(","):
                arg = re.sub(r"\bconst\b", "", arg).split()
                base = "void*" if "*" in "".join(arg) else arg[0]
                types.append(ctype[base])
            found[name] = types
    assert found == kernels._SIGNATURES
