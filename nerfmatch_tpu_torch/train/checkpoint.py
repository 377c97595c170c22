"""Checkpoints of the port, and the weight bridge from the JAX package.

``state_dict_from_jax`` takes JAX params as numpy arrays keyed by their
pytree path joined with ``/`` (the layout of ``pretrained/*.npz``) and
returns the reference-format torch state dict the port's modules load with
``load_state_dict(strict=True)``.  It re-implements the key mapping and
layout flips of ``nerfmatch_tpu/train/checkpoint.py:
export_torch_state_dict`` (with ``prefix=""``) without importing jax.

``save_checkpoint`` / ``load_checkpoint`` / ``latest_checkpoint`` are the
torch-native counterparts of the JAX package's orbax checkpoints: a
``<name>_<step>`` directory holding ``model.pt`` (the module's state dict,
reference key names), ``optim.pt`` and ``meta.json`` (step, config, extras
such as ``best_psnr``), with the ``keep`` newest of each name kept.

The matcher trainer's warm starts: ImageNet ConvFormer weights from a local
raw-timm file (``convert_timm_backbone``), a reference Lightning matcher
checkpoint (``load_reference_checkpoint``), or same-name same-shape
tensors grafted from a port checkpoint (``graft_state``).
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..config import namespace2dict


def _torch_key_for_path(path) -> str:
    """Pytree path (tuple of str / int) -> reference state-dict key."""
    parts = []
    p = list(path)
    i = 0
    while i < len(p):
        seg = p[i]
        nxt = p[i + 1] if i + 1 < len(p) else None
        if seg == "stages" and isinstance(nxt, int):
            parts.append(f"stages_{nxt}")          # timm FeatureListNet
            i += 2
        elif seg in ("pt_sa", "im_sa", "fine_sa") and isinstance(nxt, int):
            parts += [seg, "layers", str(nxt)]     # SelfAttentionBlock.layers
            i += 2
        elif seg == "feedforward" and nxt in ("fc1", "fc2"):
            parts += ["feedforward", "layers", "0" if nxt == "fc1" else "2"]
            i += 2
        elif seg == "proj_out":
            parts += ["proj_out", "0"]             # Sequential(Linear)
            i += 1
        elif seg == "fpn":                         # FPN convs sit on the MS
            i += 1                                 # wrapper itself
        elif seg == "layer1_outconv2" and nxt is not None:
            parts += [seg, {"conv1": "0", "bn": "1", "conv2": "3"}[nxt]]
            i += 2
        elif seg == "scale" and parts and parts[-1].startswith("attention"):
            parts += ["attend", "scale"]           # LSA temperature
            i += 1
        else:
            parts.append(str(seg))
            i += 1
    return ".".join(parts)


def _parse_path(key: str):
    return tuple(int(s) if s.isdigit() else s for s in key.split("/"))


def state_dict_from_jax(flat: Mapping[str, np.ndarray],
                        backbone_extra: str = "") -> dict:
    """``{"a/b/0/weight": array}`` JAX params -> port state dict of f32
    tensors.  ``backbone_extra="model."`` nests the backbone trunk as the
    c2f ``MetaFormer_MS`` wrapper does (its FPN convs stay on the wrapper);
    float16 fixture leaves are cast to float32."""
    out = {}
    for key, leaf in flat.items():
        path = _parse_path(key)
        tkey = _torch_key_for_path(path)
        if backbone_extra and tkey.startswith("backbone.") \
                and (len(path) < 2 or path[1] != "fpn"):
            tkey = "backbone." + backbone_extra + tkey[len("backbone."):]
        v = np.asarray(leaf, np.float32)
        if v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))      # HWIO -> OIHW
        elif v.ndim == 2 and path[-1] == "weight" \
                and not any("embedding" in str(s) for s in path):
            v = v.T                                # (in, out) -> (out, in)
        out[tkey] = torch.tensor(v)
    return out


def load_npz_params(path) -> dict:
    """A ``pretrained/*.npz`` file as the flat mapping above."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_checkpoint(ckpt_dir, step: int, model, optimizer=None, config=None,
                    extra: dict | None = None, keep: int = 3,
                    name: str = "ckpt"):
    """Write ``<ckpt_dir>/<name>_<step>`` and prune older ones of the same
    name beyond ``keep``."""
    ckpt_dir = Path(ckpt_dir)
    path = ckpt_dir / f"{name}_{step}"
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path / "model.pt")
    if optimizer is not None:
        torch.save(optimizer.state_dict(), path / "optim.pt")
    meta = {"step": step, **(extra or {})}
    if config is not None:
        meta["config"] = config if isinstance(config, dict) \
            else namespace2dict(config)
    (path / "meta.json").write_text(json.dumps(meta, default=float))
    for old in _named_checkpoints(ckpt_dir, name)[:-keep]:
        shutil.rmtree(old)
    return path


def _named_checkpoints(ckpt_dir, name: str):
    """Checkpoint dirs named exactly ``<name>_<step>``, sorted by step."""
    pat = re.compile(rf"^{re.escape(name)}_(\d+)$")
    return sorted((p for p in Path(ckpt_dir).glob(f"{name}_*")
                   if p.is_dir() and pat.match(p.name)),
                  key=lambda p: int(p.name.rsplit("_", 1)[1]))


def load_checkpoint(path, model, optimizer=None):
    """Load a :func:`save_checkpoint` directory into ``model`` (strict) and
    ``optimizer`` -> meta dict (``step``, ``config``, extras)."""
    path = Path(path)
    dev = next(model.parameters()).device
    model.load_state_dict(torch.load(path / "model.pt", map_location=dev,
                                     weights_only=True), strict=True)
    if optimizer is not None and (path / "optim.pt").exists():
        optimizer.load_state_dict(torch.load(path / "optim.pt",
                                             map_location=dev,
                                             weights_only=True))
    return json.loads((path / "meta.json").read_text())


def latest_checkpoint(ckpt_dir, name: str = "ckpt"):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    ckpts = _named_checkpoints(ckpt_dir, name)
    return ckpts[-1] if ckpts else None


# ---------------------------------------------------------------------------
# Matcher warm starts
# ---------------------------------------------------------------------------

def load_timm_state(ckpt) -> dict:
    """A raw timm state dict from a local ``.pth`` (``torch.load`` with
    ``weights_only=True``; hub wrappers under ``state_dict`` / ``model``
    unwrapped) or ``.npz`` -> {key: f32 tensor}."""
    ckpt = Path(ckpt)
    if ckpt.suffix == ".npz":
        with np.load(ckpt) as z:
            return {k: torch.from_numpy(np.asarray(z[k], np.float32))
                    for k in z.files}
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(state, dict) and isinstance(state.get(key), dict):
            state = state[key]
    return {k: v.detach().float() for k, v in state.items()}


def convert_timm_backbone(trunk: torch.nn.Module, timm_state: Mapping):
    """Copy a raw timm MetaFormer state dict (dotted ``stages.N.`` keys) into
    the port's ConvFormer trunk (``stages_N.``, the FeatureListNet
    flattening) -> (loaded keys, trunk keys left at init)."""
    remapped = {re.sub(r"^stages\.(\d+)\.", r"stages_\1.", k): v
                for k, v in timm_state.items()}
    return graft_state(trunk, remapped)


def graft_state(module: torch.nn.Module, state: Mapping):
    """Copy every entry of ``state`` whose key and shape match one of
    ``module``'s state entries -> (copied keys, module keys left as they
    were).  Keys only in ``state`` are ignored."""
    own = module.state_dict()
    take = {k: v for k, v in state.items()
            if k in own and tuple(own[k].shape) == tuple(v.shape)}
    with torch.no_grad():
        for k, v in take.items():
            own[k].copy_(torch.as_tensor(v, dtype=own[k].dtype))
    return sorted(take), sorted(set(own) - set(take))


def load_reference_checkpoint(ckpt_path):
    """A reference Lightning checkpoint (a pickle: load only files you trust)
    -> (state dict with the ``model.`` prefix stripped, hyper-parameters or
    None)."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    return ({(k[len("model."):] if k.startswith("model.") else k):
             torch.as_tensor(v).float() for k, v in state.items()},
            ckpt.get("hyper_parameters"))


def nest_backbone(state: Mapping) -> dict:
    """A coarse matcher's state dict keyed for the two-scale model: its trunk
    ``backbone.X`` moves to ``backbone.model.X`` (the FPN convs sit on the
    wrapper), the reference's ``backbone`` -> ``backbone.model`` remap."""
    return {("backbone.model." + k[len("backbone."):]
             if k.startswith("backbone.") else k): v for k, v in state.items()}
