"""One rank of the port's data-parallel CPU checks (``tests/
test_torch_parallel.py``): a ``gloo`` process group over
``NERFMATCH_*``-style arguments, then, from the inputs the test wrote,

* ``all_gather_host`` of a per-rank list;
* NeRF: two ``NerfTrainer`` steps on this rank's block of two global ray
  batches (``ray_batches`` under the group), once with the test's injected
  global draws (cut to the rank's rows here) and once with the trainer's
  own generator;
* c2f matcher: one ``C2FTrainStep`` on this rank's pair with the injected
  global match list, one with the step's own generator, and one with the
  losses normalized per rank (``group=None``) and the gradients averaged,
  as a plain DDP step would (with the test's per-rank match lists).

    python tests/torch_parallel_worker.py RANK WORLD PORT WORKDIR

Writes ``WORKDIR/out<RANK>.pt``.  Imports neither jax nor the JAX package.
Before any step it calls every vectorized transcendental once on both
intra-op threads (``tests/_cpu.py``: in a fresh process a thread's first
such call can come back inaccurate).
"""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _cpu import warm_up_vector_math  # noqa: E402  (tests/, the script's dir)

from nerfmatch_tpu_torch.config import load_yaml_config  # noqa: E402
from nerfmatch_tpu_torch.data.loaders import init_data_loader  # noqa: E402
from nerfmatch_tpu_torch.models.matcher_c2f import (  # noqa: E402
    C2FMatcherConfig, NeRFMatcherMS)
from nerfmatch_tpu_torch.parallel.distributed import (  # noqa: E402
    DataGroup, maybe_initialize_distributed)
from nerfmatch_tpu_torch.parallel.mesh import all_gather_host  # noqa: E402
from nerfmatch_tpu_torch.train.matcher_trainer import C2FTrainStep  # noqa
from nerfmatch_tpu_torch.train.nerf_trainer import NerfTrainer  # noqa: E402


def nerf_steps(cfg, start, draws, rank):
    trainer = NerfTrainer(cfg, device="cpu")
    trainer.renderer.load_state_dict(start, strict=True)
    ds = init_data_loader(cfg.data, cfg.exp.batch_size, split="train").dataset
    gen = torch.Generator().manual_seed(7)
    losses = []
    for i, b in enumerate(ds.ray_batches(cfg.exp.batch_size,
                                         np.random.default_rng(0))):
        if i == 2:
            break
        n = len(b["rays"])
        d = None if draws is None else \
            {k: v[rank * n:(rank + 1) * n] for k, v in draws[i].items()}
        m = trainer.train_step(torch.from_numpy(b["rays"]),
                               torch.from_numpy(b["rgbs"]), gen, draws=d)
        losses.append(float(m["loss"]))
    return losses, trainer.renderer.state_dict()


def c2f_step(inp, rank, world, mode):
    model = NeRFMatcherMS(C2FMatcherConfig(**inp["c2f_cfg"]))
    model.load_state_dict(inp["c2f_start"], strict=True)
    opt = torch.optim.SGD(model.parameters(), lr=inp["lr"], momentum=0.0)
    batch = {k: torch.from_numpy(v[rank:rank + 1])
             for k, v in inp["c2f_batch"].items()}
    gen = torch.Generator().manual_seed(11)
    if mode == "per_rank":
        step = C2FTrainStep(model, opt)
        loss, _ = step.losses(batch, mlist=inp["mlists_per_rank"][rank])
        opt.zero_grad()
        loss.backward()
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad)
                p.grad /= world
        opt.step()
        loss = torch.tensor(float(loss))
        dist.all_reduce(loss)
        return float(loss) / world, model.state_dict()
    step = C2FTrainStep(model, opt, generator=gen, group=DataGroup.current())
    m = step.step(batch, mlist=inp["mlist"] if mode == "global" else None)
    return float(m["loss"]), model.state_dict()


def main():
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], Path(sys.argv[4]))
    maybe_initialize_distributed(
        {"NERFMATCH_COORDINATOR": f"127.0.0.1:{port}",
         "NERFMATCH_NUM_PROCESSES": str(world),
         "NERFMATCH_PROCESS_ID": str(rank)}, device="cpu")
    torch.set_num_threads(2)
    warm_up_vector_math()
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {"gathered": all_gather_host([rank, rank + 10])}
    cfg, _ = load_yaml_config(inp["nerf_cfg"])
    out["nerf_injected"] = nerf_steps(cfg, inp["nerf_start"],
                                      inp["nerf_draws"], rank)
    out["nerf_generator"] = nerf_steps(cfg, inp["nerf_start"], None, rank)
    for mode in ("global", "generator", "per_rank"):
        out[f"c2f_{mode}"] = c2f_step(inp, rank, world, mode)
    torch.save(out, workdir / f"out{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
