"""Multi-process data parallelism over ``torch.distributed`` (counterpart of
``nerfmatch_tpu/parallel/distributed.py``).

Training runs one process per GPU.  Two launch contracts form the process
group:

* torchrun's: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT`` (``torchrun --nproc_per_node=N -m
  nerfmatch_tpu_torch.cli.train_nerf ...``), read by ``env://`` from the
  process environment;
* the JAX package's: ``NERFMATCH_COORDINATOR=host:port``,
  ``NERFMATCH_NUM_PROCESSES``, ``NERFMATCH_PROCESS_ID`` (the GPU is
  ``LOCAL_RANK`` where it is set, else the process id modulo the visible
  GPUs).

The backend follows the device, NCCL on CUDA and gloo on the CPU, unless the
caller names one (two ranks on one GPU run over gloo: NCCL refuses them).
Every rank loads its contiguous block of each identically shuffled global
batch (:func:`local_slice`); :class:`DataGroup` makes the trainers' loss
normalizers global and sums the gradients with one all-reduce, so a step over
W ranks is one process's step over the global batch.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

_ENV_COORD = "NERFMATCH_COORDINATOR"
_ENV_NPROC = "NERFMATCH_NUM_PROCESSES"
_ENV_PID = "NERFMATCH_PROCESS_ID"
# Longer than any step or validation epoch, so a rank that died shows as an
# error on the others instead of a hang.
TIMEOUT = timedelta(minutes=30)


def _launch(env):
    """(init_method, world, rank, local_rank or None) of the launch contract
    in ``env``, or None."""
    if env.get(_ENV_COORD):
        local = env.get("LOCAL_RANK")
        return (f"tcp://{env[_ENV_COORD]}", int(env[_ENV_NPROC]),
                int(env[_ENV_PID]), None if local is None else int(local))
    if "RANK" in env and "WORLD_SIZE" in env:
        return ("env://", int(env["WORLD_SIZE"]), int(env["RANK"]),
                int(env.get("LOCAL_RANK", 0)))
    return None


def maybe_initialize_distributed(env=None, device="cuda",
                                 backend: str | None = None):
    """Form the process group when a launch contract is set (a no-op when
    one is formed already) -> ``(rank, world)``; ``(0, 1)`` and no group
    without a contract.  On CUDA the process's GPU becomes the current
    device before the group forms.  The CLIs call it first thing in
    ``main``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    launch = _launch(os.environ if env is None else env)
    if launch is None:
        return 0, 1
    init_method, world, rank, local = launch
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "(--device cpu) for a CPU process group")
        gpu = rank % torch.cuda.device_count() if local is None else local
        torch.cuda.set_device(gpu)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", gpu)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT,
                            **kw)
    return rank, world


def process_info() -> tuple[int, int]:
    """(rank, world) of this process; (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_slice(global_batch: int, pid: int | None = None,
                pcount: int | None = None) -> slice:
    """The contiguous rows of a size-``global_batch`` batch that this
    process owns; ``global_batch`` must divide by the process count (train
    loaders drop the remainder)."""
    if pid is None or pcount is None:
        pid, pcount = process_info()
    assert global_batch % pcount == 0, \
        f"global batch {global_batch} % processes {pcount} != 0"
    per = global_batch // pcount
    return slice(pid * per, (pid + 1) * per)


def check_world(config, world: int):
    """``exp.gpus`` caps the devices, as in JAX (0: every launched
    process; a cap at or above the world trains on the world); a launched
    world cannot shrink, so a cap below it raises."""
    gpus = int(getattr(getattr(config, "exp", None), "gpus", 0) or 0)
    if 0 < gpus < world:
        raise ValueError(f"exp.gpus={gpus} is below the {world} launched "
                         "processes: launch as many processes as GPUs to "
                         "train on")


def rank_seed(seed: int, rank: int) -> int:
    """A seed of numpy's global generator for ``rank``: ``seed`` itself on
    rank 0 (one process draws as before), a ``SeedSequence`` child on the
    others, so no two ranks draw the same samples."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), rank]).generate_state(1)[0])


class DataGroup:
    """This process's place in the data-parallel training group (the
    default process group): the collectives that make a W-rank step one
    step over the global batch.  Every method works on the tensors'
    device; gloo takes CUDA tensors for all-reduce and broadcast only, so
    gathers are all-reduces of zero-padded blocks."""

    def __init__(self):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()

    @classmethod
    def current(cls):
        """The group of this process, None without a process group."""
        return cls() if dist.is_initialized() else None

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * world``."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)

    def _reduce(self, x, op):
        x = x.detach().clone()
        dist.all_reduce(x, op=op)
        return x

    def sum(self, x):
        """The sum over the ranks of ``x`` (a count or a statistic: no
        gradient flows through it)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def amax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def amin(self, x):
        return self._reduce(x, dist.ReduceOp.MIN)

    def gather(self, x):
        """The ranks' ``x`` (equal shapes) concatenated on dim 0 in rank
        order, detached; bool stays bool."""
        n = x.shape[0]
        dtype = torch.int32 if x.dtype == torch.bool else x.dtype
        out = torch.zeros((self.world * n, *x.shape[1:]), dtype=dtype,
                          device=x.device)
        out[self.rows(n)] = x.detach().to(dtype)
        dist.all_reduce(out)
        return out.bool() if x.dtype == torch.bool else out

    def sum_metrics(self, metrics: dict) -> dict:
        """One all-reduce of a dict of scalar tensors -> their sums."""
        keys = list(metrics)
        flat = self.sum(torch.stack([metrics[k].reshape(()) for k in keys]))
        return dict(zip(keys, flat.unbind()))

    def reduce_grads(self, params):
        """Sum every gradient over the ranks in one all-reduce of a flat
        buffer (a parameter without a gradient sends zeros and keeps
        none)."""
        params = [p for p in params if p.requires_grad]
        if not params:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat)
        off = 0
        for p in params:
            if p.grad is not None:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()

    def barrier(self):
        dist.barrier()
