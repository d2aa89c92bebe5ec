"""Process groups for data-parallel training and spatially sharded renders.

Counterpart of `dimo_tpu/parallel/mesh.py`. The reference shards one
jitted step over a device mesh and lets XLA insert the collectives; here
each rank is a process (launched by `torchrun`, or spawned), and the
step and the rasterizer call the collectives themselves:

  * data parallelism (`Trainer(data_parallel=N)`, `train/step.py`): every
    rank draws the same batch meta, takes its contiguous B/N render jobs
    (`shard_batch`), computes its part of the global loss, and the
    gradients are summed over ranks before the update, so the replicated
    state stays the same on every rank;
  * spatial parallelism (`rasterize(..., sp=...)`): one render's strips
    are dealt to ranks by count, each rank composites its own, and the
    planes are summed over ranks.

Only `all_reduce` and `broadcast` are used: both run under NCCL and
under gloo, on CUDA tensors too. The backend is NCCL for ranks with a
card each, gloo on the CPU; ranks that share one card use gloo, asked
for by name (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (default) process group: its rank, the
    group's size and the device it computes on."""
    rank: int
    size: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of n jobs."""
        if n % self.size:
            raise ValueError(
                f"batch of {n} render jobs not divisible by "
                f"data_parallel={self.size}; adjust batch_size/"
                "num_views/num_frames so motions*views*frames % ranks == 0")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def init_from_env(timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the group `torchrun` describes in the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), unless a group is already
    initialized. NCCL with a card, binding rank LOCAL_RANK to its card;
    gloo without one. Returns whether a group is initialized."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s))
    return True


def make_mesh(n: int | None = None, axis: str = "data",
              device=None) -> Mesh:
    """The mesh of n ranks over the initialized group (its whole world by
    default; joins torchrun's group first if the environment names one).
    Raises when there is no group of n ranks, and under NCCL when there
    are fewer cards than ranks. `device` defaults to the rank's card under
    NCCL and the CPU under gloo."""
    option = {"data": "data_parallel", "sp": "spatial_parallel"}.get(
        axis, f"{axis}_parallel")
    if not init_from_env():
        raise ValueError(
            f"{option}={n} needs one process per rank: launch with "
            f"`torchrun --nproc_per_node {n} ...` (or initialize a "
            "torch.distributed group first)")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if world < n:
        raise ValueError(f"requested a {n}-rank '{axis}' mesh but the "
                         f"process group has only {world} ranks")
    if world != n:
        raise ValueError(f"requested a {n}-rank '{axis}' mesh in a group of "
                         f"{world} ranks: the mesh spans the whole group")
    backend = dist.get_backend()
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if cards < n:
            raise ValueError(f"{option}={n} over NCCL needs {n} cards; "
                             f"{cards} are visible")
        if device is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device is None:
        device = torch.device("cpu")
    return Mesh(rank=dist.get_rank(), size=n, device=torch.device(device))


def make_sp_mesh(n: int | None = None, device=None) -> Mesh:
    """Mesh for SPATIAL parallelism of one render: the rasterizer deals its
    strips over the ranks (`ops/rasterizer/api.py`, `sp`). Raises when the
    group has fewer ranks (a silent 1-rank mesh would report sharded
    numbers that measured the unsharded path)."""
    return make_mesh(n, axis="sp", device=device)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Every per-job leaf (leading axis = the batch's job count, taken
    from "times") cut to this rank's contiguous rows; other values
    replicated as they are. "latent_idx_all" keeps the whole batch's
    latent indices (the step's terms of the parameters alone read every
    motion of the batch)."""
    n = len(batch["times"])
    rows = mesh.rows(n)
    out = {k: (v[rows] if hasattr(v, "__len__") and not isinstance(v, tuple)
               and len(v) == n else v)
           for k, v in batch.items()}
    out["latent_idx_all"] = batch.get("latent_idx_all", batch["latent_idx"])
    return out


def replicate(tensors, mesh: Mesh, src: int = 0) -> None:
    """Overwrite every tensor of an iterable, in place, with rank src's
    (bool tensors travel as uint8, which every backend carries)."""
    with torch.no_grad():
        for t in tensors:
            if t.dtype == torch.bool:
                u8 = t.to(torch.uint8)
                dist.broadcast(u8, src=src)
                t.copy_(u8.bool())
            else:
                dist.broadcast(t.detach(), src=src)


def all_reduce_(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (sum or max) of t over the mesh; returns t."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM)
    return t


def sum_flat_(tensors: list, mesh: Mesh) -> None:
    """Sum a list of float32 tensors over the mesh in place, as one
    buffer (one collective instead of one per tensor)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, mesh)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def barrier(mesh: Mesh) -> None:
    """Every rank waits for the others (an all-reduce of one element, so
    it runs on every backend the mesh uses)."""
    all_reduce_(torch.zeros(1, device=mesh.device), mesh)


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of each rank's tensor. Backward: the gradient as
    it is: every rank holds the same loss of the sum, so each rank's
    addend has the full gradient of it."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedToSharded(torch.autograd.Function):
    """Forward: the identity. Backward: the sum of every rank's gradient,
    where a replicated tensor feeds work that each rank does a share of."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh), None


def sum_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum over ranks (see `_SumOverRanks`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverRanks.apply(x, mesh)
    return all_reduce_(x.clone(), mesh)


def shard_input(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated tensor entering sharded work (see
    `_ReplicatedToSharded`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReplicatedToSharded.apply(x, mesh)
    return x
