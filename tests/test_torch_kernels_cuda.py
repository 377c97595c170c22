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
from nerfmatch_tpu_torch.ops.kernels.attention_kernel import (attention_plain,
                                                              fused_attention)
from nerfmatch_tpu_torch.ops.kernels.render_kernel import (render_stage,
                                                           render_stage_plain)
from nerfmatch_tpu_torch.ops.kernels.resample_kernel import (resample_z,
                                                             resample_z_plain)


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
def test_resample_kernel_matches_plain(dev):
    """Inverse-CDF resample at atol 1e-5, including an all-zero row."""
    rays, z = rays_z(256, dev)
    w = torch.rand(256, 128, device=dev, generator=torch.Generator(dev).manual_seed(0))
    w[3] = 0.0
    torch.testing.assert_close(resample_z(z, w), resample_z_plain(z, w),
                               atol=1e-5, rtol=0)


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
    q = torch.randn(1, 300, 2, 32, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError):
        fused_attention(q, q.detach(), q.detach())


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
