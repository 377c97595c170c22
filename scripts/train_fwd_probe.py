"""What the NeRF train-render forward (kernel 5) is made of, on one NVIDIA
GPU.

    python3 scripts/train_fwd_probe.py
    python3 scripts/train_fwd_probe.py --grads OUT.pt

Builds ``nerfmatch_tpu_torch/csrc/render_train.cu`` once per variant below,
each an edited copy of the sources (``PATCHES``, built as
``scripts/train_bwd_probe.py`` builds its variants), into
``build/train_fwd_probe/<variant>/``:

* ``shipped``: as the package builds it;
* ``no_mma``: the forward issues no ``wgmma`` (the ring, the encoding,
  the epilogues, the heads, the compositing and the stash stores stay);
* ``no_ring``: the forward loads no weight slices after its prologue and
  waits for none (the products run on whatever the slots hold);
* ``bare``: neither products nor weight slices (what remains: the
  encoding, the epilogues, the heads, the barriers, the compositing and the
  stash stores);
* ``no_ipe``: the encoding skips its ``sinf`` / ``expf`` (it stores the
  scaled means and variances instead).

Then, on phase 3b's stage of ``chip_smoke.py`` (the room's fine MLP, 9216
rays x 128 samples), it runs each build's ``nm_render_train_forward`` three
times with a stash (the training forward) and three times without (the
no-gradient forward) under ``torch.profiler`` and prints the device ms of
``train_fwd_kernel`` a call, one JSON line per variant after the card's
name and power limit.  The shipped build's outputs must equal the
package's bit for bit; the probe builds compute something else and are
only timed.  Compare within one run only.

With ``--grads OUT`` it instead saves, to ``OUT``, the rgb, weights and
every parameter gradient of that stage through ``render_train`` and
autograd (the training path) with this checkout's package.  Run it in
each of two checkouts and compare the two files (``torch.equal`` on
every tensor) to hold them bit for bit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SS = """        wgmma_ss<N, 0>(acc, desc128(enc_w + (ks >> 2) * L::kEncBlock + (ks & 3) * 32, 16),
                       desc128(slot + kk * 2048, kSliceK * 128), ks > 0);
"""
_RS = """        wgmma_rs<N, 1>(acc, a[s * KK + kk], desc128(slot + kk * 2048, kSliceK * 128),
                       NE + s + kk > 0);
"""
_RING = """      if (tid == 0 && q + kFwdRing - 2 < q_total) load_slice(q + kFwdRing - 2);
      mbar_wait(full0 + 8 * (q % kFwdRing), (q / kFwdRing) & 1);
"""
_IPE = """        const float damp = expf(-0.5f * y);
        const __nv_bfloat16 v[2] = {__float2bfloat16(damp * sinf(x)),
                                    __float2bfloat16(damp * sinf(x + kHalfPi))};
"""
# (old, new) edits of render_train.cu, or (file, old, new), per variant.
PATCHES = {
    "shipped": [],
    "no_mma": [(_SS, "        (void)slot;\n"), (_RS, "        (void)slot;\n")],
    "no_ring": [(_RING, "")],
    "bare": [(_SS, "        (void)slot;\n"), (_RS, "        (void)slot;\n"),
             (_RING, "")],
    "no_ipe": [(_IPE, _IPE.replace("damp * sinf(x)", "x").replace(
        "damp * sinf(x + kHalfPi)", "y"))]}
LAUNCHES = {"train_fwd_kernel": "fwd"}


def save_grads(out):
    """The training path's outputs and gradients on phase 3b's stage."""
    import torch

    import chip_smoke as smoke
    from nerfmatch_tpu_torch.ops.kernels.render_train_kernel import (
        render_train)

    smoke.phase_environment()
    dev = torch.device("cuda", 0)
    renderer = smoke.load_room_renderer(dev)
    spec, rays, z, noise, target = smoke.train_inputs(renderer, dev)
    spec.mlp.zero_grad()
    rgb, w = render_train(spec, rays, z, noise)
    ((rgb - target) ** 2).mean().add(0.1 * (w ** 2).mean()).backward()
    torch.cuda.synchronize()
    res = {"rgb": rgb.detach().cpu(), "weights": w.detach().cpu()}
    res.update({k: p.grad.cpu() for k, p in spec.mlp.named_parameters()})
    torch.save(res, out)
    print(f"saved {len(res)} tensors to {out}", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grads", help="save the training path's gradients here")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.grads:
        save_grads(args.grads)
        return
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch

    import chip_smoke
    from nerfmatch_tpu_torch.ops import kernels
    from nerfmatch_tpu_torch.ops.kernels import render_train_kernel as rtk
    from train_bwd_probe import build_variants, profile_ms

    smi = chip_smoke.phase_environment()
    dev = torch.device("cuda", 0)
    libs = build_variants(PATCHES, "train_fwd_probe")
    renderer = chip_smoke.load_room_renderer(dev)
    spec, rays, z, noise, _ = chip_smoke.train_inputs(renderer, dev)
    packed = rtk.pack_train(spec.mlp)
    with torch.no_grad():
        rgb, w, stash = rtk.kernel_forward(spec, rays, z, noise, packed,
                                           stash=True)
    args = rtk._kernel_args(spec, rays, z, noise, packed)
    ref = (rgb, w, stash.clone())
    outs = (torch.empty_like(rgb), torch.empty_like(w))

    def run(lib, st, name):
        err = lib.nm_render_train_forward(
            *args, outs[0].data_ptr(), outs[1].data_ptr(),
            None if st is None else st.data_ptr(), None, 0,
            kernels.stream_ptr(dev))
        kernels.check(err, f"render_train_fwd ({name})")

    print(smi, flush=True)
    for name, lib in libs.items():
        run(lib, stash, name)
        torch.cuda.synchronize()
        if name == "shipped":
            assert all(torch.equal(a, b) for a, b in
                       zip(ref, (*outs, stash))), "shipped build != package"
        row = {"variant": name}
        for mode, st in (("stash", stash), ("no_stash", None)):
            ms = profile_ms(lambda: run(lib, st, name), LAUNCHES)
            row[mode] = round(ms["fwd"], 4)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
