"""Training across devices on torch.distributed (port of
nerf_emitter_tpu/parallel/mesh.py).

The reference's distributed layer is NCCL process groups, mp.spawn, rank-0
gating and pad_scatter/pad_gather of emitter rays, one process per GPU
with a TCP rendezvous. The JAX package folds all of it into one SPMD
program over a device mesh; this port goes back to the reference's
protocol in PyTorch's idiom: one process per rank, every rank holding the
whole batch's inputs and the replicated state (parameters, the SDF scene),
each rank computing its rows of the batch, and the rows gathered back.

- `maybe_initialize_distributed` joins the process group the
  `NERF_EMITTER_*` variables describe (the JAX package's names);
- `make_mesh` is this rank's view of the world (`Mesh`); a world of one
  rank is a mesh whose collectives are no-ops;
- `data_sharded` cuts a replicated batch to this rank's rows, padded to
  ceil(n / world) rows; `gather_rows` gathers every rank's rows back to
  the batch; both are differentiable, each the other's backward;
- `replicated` broadcasts replicated state from rank 0 in place, and
  `all_reduce_grads` sums the ranks' gradients;
- `RowGenerator` draws a batch's random numbers at the global batch and
  keeps this rank's rows, so a sharded step sees the draws of the one-rank
  step and every rank's generator advances in lockstep.

The backend is NCCL when each rank has a card of its own, and gloo
otherwise: on the CPU, and for ranks that share a card (NCCL refuses two
ranks on one device). On CUDA tensors gloo offers `all_reduce` and
`broadcast` only, so the gather is an all-reduce of a zero-filled global
buffer into which each rank writes its rows: one code path serves both
backends. `torch.distributed.device_mesh` does not serve here: its CUDA
meshes assume a card per rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"  # shards rays, pixels and draws


def choose_backend(device_type: str, local_world: int) -> str:
    """NCCL when every rank on the host has a card of its own, else gloo."""
    if device_type == "cuda" and dist.is_nccl_available() and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(device: Optional[str] = None) -> bool:
    """Join the process group when NERF_EMITTER_COORDINATOR is set (the
    reference's dist.init_process_group). Variables, the same on every rank:

      NERF_EMITTER_COORDINATOR   host:port of rank 0, or "auto" for
                                 torchrun's env:// (MASTER_ADDR, RANK, ...)
      NERF_EMITTER_NUM_PROCESSES world size
      NERF_EMITTER_PROCESS_ID    this process's rank

    `device` is the run's device (None: CUDA, which must be there); it
    picks the backend (`choose_backend`) and, on CUDA, this rank's card
    (cuda:<local rank>, modulo the cards the host has). Returns whether a
    process group is active. Idempotent."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("NERF_EMITTER_COORDINATOR")
    if not coord:
        return False
    if coord == "auto":
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init = f"tcp://{coord}"
        world = int(os.environ["NERF_EMITTER_NUM_PROCESSES"])
        rank = int(os.environ["NERF_EMITTER_PROCESS_ID"])
    device_type = resolve_device(device).type
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(choose_backend(device_type, local_world), init_method=init, world_size=world, rank=rank)
    return True


def is_main_process() -> bool:
    """Rank 0, or no process group (the reference's comms.is_main_process):
    host-side artifacts (checkpoints, logs, renders) are written once."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device(device_type: str) -> torch.device:
    """This rank's device: cuda:<local rank> (modulo the host's cards) on
    CUDA, the CPU otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    # torchrun's LOCAL_RANK, else every rank on one host
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank())) if dist.is_initialized() else 0
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis (DATA_AXIS) over every rank of the process group, seen from
    this rank. `shape[DATA_AXIS]` is the world size, as on a JAX mesh."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world_size}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> tuple[int, int, int]:
        """(start, stop, m): this rank's rows [start, stop) of an n-row
        batch, m = ceil(n / world) rows each, the last ranks' rows short
        (or empty) where the world does not divide n."""
        m = -(-n // self.world_size)
        start = min(self.rank * m, n)
        return start, min(start + m, n), m


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda") -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one). `n_devices`, if given, must be the world size: a mesh spans every
    rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans every rank: asked for {n_devices} of a world of {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return Mesh(rank=rank, world_size=world, device=rank_device(device_type), backend=backend)


def fill_rows(x: torch.Tensor, m: int, pad_value: Optional[float]) -> torch.Tensor:
    """x (k <= m, ...) -> (m, ...): the last row repeated (pad_value None)
    or filled with pad_value. The port's one function that pads a block of
    rows: the ranks' shards, and the kernel query's 128-ray tiles and
    recompute chunks with its pad values (ops/mega_query.py RAY_PADS)."""
    k = x.shape[0]
    if k == m:
        return x
    if pad_value is None and k > 0:
        fill = x[-1:].expand(m - k, *x.shape[1:])
    else:
        fill = torch.full((m - k, *x.shape[1:]), 0.0 if pad_value is None else pad_value, dtype=x.dtype,
                          device=x.device)
    return torch.cat([x, fill])


def _gather(x_local: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
    """Every rank's m rows -> the n-row batch (an all-reduce of a
    zero-filled (world * m)-row buffer)."""
    m = x_local.shape[0]
    buf = torch.zeros((mesh.world_size * m, *x_local.shape[1:]), dtype=x_local.dtype, device=x_local.device)
    buf[mesh.rank * m:(mesh.rank + 1) * m] = x_local
    dist.all_reduce(buf)
    return buf[:n]


def _own_rows(x: torch.Tensor, mesh: Mesh, pad_value: Optional[float]) -> torch.Tensor:
    start, stop, m = mesh.rows(x.shape[0])
    return fill_rows(x[start:stop], m, pad_value)


class _Shard(torch.autograd.Function):
    """Forward: this rank's rows of a replicated batch. Backward: the rows'
    gradients gathered back to the whole batch (the gradient of a
    replicated input is the sum over the ranks' rows)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        ctx.set_materialize_grads(False)
        return _own_rows(x, mesh, None)

    @staticmethod
    def backward(ctx, g):
        return None if g is None else _gather(g.contiguous(), ctx.mesh, ctx.n), None


class _Gather(torch.autograd.Function):
    """Forward: every rank's rows gathered to the batch. Backward: this
    rank's rows of the batch's gradient (every rank holds the same
    replicated loss downstream)."""

    @staticmethod
    def forward(ctx, x_local, mesh, n):
        ctx.mesh = mesh
        ctx.set_materialize_grads(False)
        return _gather(x_local.contiguous(), mesh, n)

    @staticmethod
    def backward(ctx, g):
        return None if g is None else _own_rows(g, ctx.mesh, 0.0), None, None


def data_sharded(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of the replicated batch x (n, ...), padded to
    ceil(n / world) rows by repeating the last row (so padded rows stay
    valid inputs). Differentiable. A one-rank mesh or no mesh returns x."""
    if mesh is None or mesh.world_size == 1:
        return x
    if x.requires_grad:
        return _Shard.apply(x, mesh)
    return _own_rows(x, mesh, None)


def gather_rows(x_local: torch.Tensor, mesh: Optional[Mesh], n: int) -> torch.Tensor:
    """Every rank's rows (data_sharded's layout) gathered back to the
    n-row batch, on every rank; padded rows are dropped. Differentiable:
    the backward hands each rank its rows' gradient."""
    if mesh is None or mesh.world_size == 1:
        return x_local[:n]
    if x_local.requires_grad:
        return _Gather.apply(x_local, mesh, n)
    return _gather(x_local.contiguous(), mesh, n)


def shard_axis(x: torch.Tensor, mesh: Optional[Mesh], axis: int) -> torch.Tensor:
    """data_sharded along `axis` (a (spp, N)-leading draw's ray axis);
    not differentiable."""
    if mesh is None or mesh.world_size == 1:
        return x
    return _own_rows(x.movedim(axis, 0), mesh, None).movedim(0, axis)


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' gradients (a
    replicated input's cotangent, psum'd). No gradient (the same on every
    rank, which runs the same graph) stays none, with no collective."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g, None


def sum_gradients(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x itself; in the backward, its gradient summed over the ranks (for
    replicated inputs of a computation split by rows)."""
    if mesh is None or mesh.world_size == 1 or not x.requires_grad:
        return x
    return _SumGradients.apply(x, mesh)


def _leaves(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    return []


def replicated(tree: Any, mesh: Optional[Mesh]) -> Any:
    """Broadcast every tensor of `tree` (tensors, dataclasses, dicts,
    lists, modules) from rank 0, in place; returns `tree`. The state every
    rank must hold identically starts from rank 0's."""
    if mesh is None or mesh.world_size == 1:
        return tree
    with torch.no_grad():
        for t in _leaves(tree):
            buf = t.detach() if t.is_contiguous() else t.detach().contiguous()
            dist.broadcast(buf, src=0)
            if buf.data_ptr() != t.data_ptr():
                t.detach().copy_(buf)
    return tree


def shard_leading_axis(tree: Any, mesh: Optional[Mesh]) -> Any:
    """Each tensor leaf whose leading axis the world divides -> this rank's
    rows; every other leaf stays replicated (dicts, lists and tuples are
    walked)."""
    if mesh is None or mesh.world_size == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        n = tree.shape[0] if tree.ndim else 0
        return data_sharded(tree, mesh) if n and n % mesh.world_size == 0 else tree
    if isinstance(tree, dict):
        return {k: shard_leading_axis(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_leading_axis(v, mesh) for v in tree)
    return tree


@torch.no_grad()
def all_reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """Sum the ranks' gradients of `params` in one all-reduce (every
    rank's backward saw its rows alone). Parameters without a gradient are
    left so; the set is the same on every rank, since every rank runs the
    same graph."""
    if mesh is None or mesh.world_size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


@torch.no_grad()
def max_replica_difference(tree: Any, mesh: Optional[Mesh]) -> float:
    """The largest |rank 0's value - this rank's| over every tensor of
    `tree`, maximised over the ranks (0 when the replicas agree)."""
    if mesh is None or mesh.world_size == 1:
        return 0.0
    leaves = [t.detach().float().reshape(-1) for t in _leaves(tree)]
    if not leaves:
        return 0.0
    mine = torch.cat(leaves)
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    diff = (mine - ref).abs().max().reshape(1) if mine.numel() else mine.new_zeros(1)
    dist.all_reduce(diff, op=dist.ReduceOp.MAX)
    return float(diff)


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank waits here (a one-element all-reduce, which both backends
    run on the mesh's device)."""
    if mesh is None or mesh.world_size == 1:
        return
    dist.all_reduce(torch.zeros(1, device=mesh.device))


def broadcast_flag(value: bool, mesh: Optional[Mesh]) -> bool:
    """Rank 0's `value` on every rank."""
    if mesh is None or mesh.world_size == 1:
        return bool(value)
    t = torch.tensor([1.0 if value else 0.0], device=mesh.device)
    dist.broadcast(t, src=0)
    return bool(t.item() > 0.5)


class RowGenerator:
    """A generator whose per-row draws are made for the whole n-row batch
    and cut to this rank's rows (data_sharded's layout): `rand`'s leading
    axis is the rank's row count, the draw's the batch's. Every rank draws
    the whole batch, so all generators advance in lockstep."""

    def __init__(self, generator: torch.Generator, mesh: Mesh, n: int):
        self.generator, self.mesh, self.n = generator, mesh, n

    def rand(self, shape, device) -> torch.Tensor:
        full = torch.rand((self.n, *shape[1:]), generator=self.generator, device=device)
        return _own_rows(full, self.mesh, None)


def rand(shape, generator, device) -> torch.Tensor:
    """torch.rand(shape) from `generator`, or a RowGenerator's rows of the
    batch's draw."""
    if isinstance(generator, RowGenerator):
        return generator.rand(shape, device)
    return torch.rand(shape, generator=generator, device=device)


def row_generator(generator: Optional[torch.Generator], mesh: Optional[Mesh], n: int):
    """`generator` for a rank's rows of an n-row batch: itself without a
    mesh (or a generator), else a RowGenerator."""
    if generator is None or mesh is None or mesh.world_size == 1:
        return generator
    return RowGenerator(generator, mesh, n)
