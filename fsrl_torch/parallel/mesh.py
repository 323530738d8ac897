"""Data parallelism over ``torch.distributed`` (port of
``fsrl_tpu/parallel/mesh.py``).

In the JAX package the env axis is sharded over a ``dp`` mesh, the
parameters are replicated, and GSPMD turns every reduction over the batch
into an all-reduce, so a run on W devices computes what one device computes.
The port has no GSPMD and gets the same result by explicit design:

* one process per card, started by ``torchrun``; each rank steps a
  contiguous block of ``N / W`` envs and keeps a replica of the parameters;
* every draw that spans the env or batch axis comes from a generator seeded
  alike on every rank: each rank draws the global tensor and keeps its own
  rows (:class:`EnvRows`), so a run on W ranks draws what one process draws.
  These draws are small (at 4096 envs and 2 actions, 8,192 normals a step).
  The collect's policy runs on all N rows (the others' rows zero,
  :class:`EnvRows`) so that every row rounds as in one process: at these
  widths its forward is bound by its launches, not its rows
  (``chip_smoke.py``'s ``[dp ...]`` lines measure both forms). Their cost
  is the price of a result that does not depend on W;
* each reduction over the batch is one ``all_reduce`` of the ranks' partial
  results (:class:`DPGroup`): a mean over rows is the sum over ranks of
  ``n_r / n`` times the rank's own mean, so every rank takes the same
  optimizer step and the same host decisions.

Only ``all_reduce`` and ``broadcast`` are used. gloo runs both on CUDA
tensors too, so two ranks can share one card; NCCL refuses two ranks on
one device.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from fsrl_torch.device import resolve_device

Tensor = torch.Tensor

DP_AXIS = "dp"
HOST_AXIS = "host"
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def rank_device(device=None) -> torch.device:
    """This rank's device, made the current CUDA device before any other
    CUDA work of the process (otherwise the ranks of a multi-card machine
    all open a context on card 0). ``None`` is ``cuda:LOCAL_RANK``;
    ``"cpu"`` and ``"cuda:k"`` are taken as given."""
    if device is None:
        resolve_device(None)                      # raises without CUDA
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
    return dev


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA tensors, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(n_devices: int | None = None, backend: str | None = None,
              device=None, axis: str = DP_AXIS) -> DeviceMesh:
    """A 1-D data-parallel ``DeviceMesh`` named ``(axis,)`` over every rank,
    the process group initialised from ``torchrun``'s environment where it
    is not up yet. ``backend`` overrides the default of
    :func:`default_backend`; nothing switches it on its own."""
    dev = rank_device(device)
    if not dist.is_initialized():
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"make_mesh needs torchrun's environment ({', '.join(missing)}"
                f" not set): start the program with torchrun "
                f"--nproc_per_node <cards> ...")
        dist.init_process_group(backend or default_backend(dev))
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"the mesh spans every rank: {world}, not "
                         f"{n_devices}")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, backend: str | None = None,
                   device=None) -> None:
    """Bring up the process group over TCP: one call in each process,
    ``coordinator_address`` (``host:port``) being process 0's."""
    dev = rank_device(device)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_multihost_mesh(axis: str = DP_AXIS, hierarchical: bool = False,
                        device=None) -> DeviceMesh:
    """The global mesh over every rank of the initialised process group:
    one flat ``(axis,)`` dimension, or with ``hierarchical`` a 2-D
    ``(host, axis)`` mesh of ``LOCAL_WORLD_SIZE`` ranks a host (1 where
    the launcher does not set it). Ranks are host-major, so each host's
    block is contiguous."""
    dev = rank_device(device)
    world = dist.get_world_size()
    if not hierarchical:
        return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if world % local:
        raise ValueError(f"{world} ranks do not fill hosts of {local}")
    return init_device_mesh(dev.type, (world // local, local),
                            mesh_dim_names=(HOST_AXIS, axis))


# (``torch.distributed.tensor`` is imported where it is used: it costs a
# second, and the collector imports this module)
def env_sharding(mesh: DeviceMesh, batch_axis: int = 0) -> tuple:
    """The placement of the env axis: sharded over every mesh dimension."""
    from torch.distributed.tensor import Shard
    return (Shard(batch_axis),) * mesh.ndim


def replicated(mesh: DeviceMesh) -> tuple:
    """The placement of a replicated tensor."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


# ---------------------------------------------------------------------------
# The data-parallel group of a mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DPGroup:
    """This rank's place among the mesh's ``size`` ranks (all of its
    dimensions, host-major), and the collectives the training loop needs."""

    group: Any      # the ProcessGroup over the whole mesh
    rank: int
    size: int

    @classmethod
    def of(cls, mesh: DeviceMesh) -> "DPGroup":
        group = (mesh.get_group(0) if mesh.ndim == 1
                 else dist.group.WORLD)
        if mesh.size() != dist.get_world_size(group):
            raise ValueError("the data-parallel mesh must span its group")
        return cls(group, dist.get_rank(group), mesh.size())

    def block(self, n: int) -> tuple[int, int]:
        """This rank's contiguous rows ``[lo, hi)`` of ``n`` (divisible)."""
        if n % self.size:
            raise ValueError(f"{n} does not divide over {self.size} ranks")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def all_sum(self, *tensors: Tensor) -> list[Tensor]:
        """The sum over ranks of each tensor, with one ``all_reduce`` of
        their concatenation (all of one dtype and device)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off: off + t.numel()].view(t.shape))
            off += t.numel()
        return out

    def weighted_sum(self, weight: float, *tensors: Tensor) -> list[Tensor]:
        """``sum_r weight_r * t_r`` for each tensor: with ``weight`` the
        rank's share ``n_r / n`` of the rows and ``t_r`` its mean over
        them, the global mean. The weighted flat all-reduce of every grad
        step."""
        return self.all_sum(*(t * weight for t in tensors))

    def broadcast_(self, tensor: Tensor, src: int = 0) -> Tensor:
        """``tensor`` from rank ``src`` of the group, in place."""
        dist.broadcast(tensor, group=self.group,
                       src=dist.get_global_rank(self.group, src))
        return tensor

    def share_from_rank0(self, values: list[float],
                         generator: torch.Generator,
                         device: torch.device) -> list[float]:
        """Rank 0's host ``values`` and generator state on every rank (one
        broadcast): what a step run on rank 0 alone (the episode-exact
        test) hands the others, so that every rank leaves the loop together
        and goes on drawing what one process draws."""
        state = generator.get_state()
        buf = torch.cat([torch.tensor(values, dtype=torch.float64)
                         .view(torch.uint8), state]).to(device)
        self.broadcast_(buf)
        buf = buf.cpu()
        k = 8 * len(values)
        generator.set_state(buf[k:].clone())
        return buf[:k].view(torch.float64).tolist()


class EnvRows:
    """The shared generator and this rank's rows ``[lo, hi)`` of the
    ``n_total`` envs, in the place of a generator: the collector draws
    every step's randomness at the global size from ``generator`` and cuts
    the rank's rows (:meth:`cut`), and runs the policy on the global batch
    with the other ranks' rows zero (:meth:`pad`): a matrix product's
    rounding may depend on how many rows it has, so only the global shape
    gives each row the one-process arithmetic."""

    def __init__(self, generator: torch.Generator, n_total: int, lo: int,
                 hi: int):
        self.generator, self.n_total, self.lo, self.hi = (
            generator, n_total, lo, hi)

    def cut(self, tree: Any) -> Any:
        """Rows ``[lo, hi)`` of every tensor leaf of ``tree``."""
        return tree_map(lambda x: x[self.lo: self.hi], tree)

    def pad(self, x: Tensor) -> Tensor:
        """The rank's rows ``x`` at rows ``[lo, hi)`` of a zero tensor of
        ``n_total`` rows."""
        full = x.new_zeros((self.n_total,) + tuple(x.shape[1:]))
        full[self.lo: self.hi] = x
        return full


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every tensor leaf of dataclasses, dicts, lists and tuples;
    other leaves are kept."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tensors_of(tree: Any):
    """Every tensor of ``tree``, a module's parameters and buffers
    included."""
    if isinstance(tree, Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors_of(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)


def shard_env_state(mesh: DeviceMesh, env_state: Any) -> Any:
    """This rank's contiguous block of every leaf whose leading axis is the
    (divisible) env axis; scalars and leaves whose leading axis does not
    divide over the ranks are kept whole (replicated)."""
    dp = DPGroup.of(mesh)

    def place(x: Tensor) -> Tensor:
        n = x.shape[0] if x.dim() else 0
        if n >= dp.size and n % dp.size == 0:
            lo, hi = dp.block(n)
            return x[lo:hi].clone()
        return x

    return tree_map(place, env_state)


def check_rank_device(tree: Any) -> None:
    """Raise unless the CUDA tensors of ``tree`` are on this rank's card
    (the current device that :func:`make_mesh` set): a model built before
    the mesh lands on card 0 on every rank."""
    if not torch.cuda.is_available():
        return
    here = torch.cuda.current_device()
    for x in tensors_of(tree):
        if x.is_cuda and x.device.index != here:
            raise RuntimeError(
                f"a tensor of the training state is on {x.device}, this "
                f"rank's card is cuda:{here}: make the mesh before the "
                f"algorithm or agent")


@torch.no_grad()
def replicate_tree(mesh: DeviceMesh, tree: Any) -> Any:
    """Rank 0's value of every tensor of ``tree`` on every rank (in place;
    a module's parameters included) and the tree."""
    dp = DPGroup.of(mesh)
    for x in tensors_of(tree):
        dp.broadcast_(x.data if isinstance(x, nn.Parameter) else x)
    return tree
