"""Named mesh axes over the ranks of a `torch.distributed` job, the
collectives the multi-device paths use, and a rank launcher.

PyTorch port of `repro.launch.mesh`.  The JAX package runs one controller
over a device mesh and writes its multi-device sections as `shard_map`
bodies; here every rank is a process (PyTorch's own SPMD idiom) and runs
the same body on its block.  A `Mesh` names the axes of the world's ranks
in row-major order: rank r sits at `np.unravel_index(r, sizes)`, as a
device of `jax.make_mesh` does.  Each set of axes has its process groups
(one a coordinate of the other axes, made at first use, the same order on
every rank), and the bodies reach them only through `axis_index`,
`axis_size`, `all_reduce` (sum or max), and `all_gather` and
`reduce_scatter` along a dim.

Backends: NCCL with one card a rank on a machine of two or more cards;
gloo on the CPU, and gloo for ranks that share one card, where the
collectives stage their CUDA tensors through pinned host copies (the
kernels still run on the card; a gathered block is copied back to the
card before the blocks are joined, a reduce-scattered sum only as this
rank's block).  `card_world` picks the backend from the card
count; nothing picks it by catching a failure, and a collective that
fails raises.

A mesh spans the first `size` ranks of the world, as the reference's
`jax.devices()[:n]` does (`runtime.elastic.shrink_mesh`): a rank outside
it has no coordinates (`member` False) and takes part in no collective
(each raises there).  The groups of a mesh that spans the whole world
are made by every rank, in one order (its whole set of ranks is
`WORLD`); those of a smaller mesh by their members alone
(`use_local_synchronization`), so that a rank outside it need not
enter.  With no process group, a mesh's axes must all have size 1, and
every collective is the identity: the single-card paths are unchanged.

`CountingMesh` is a stand-in for counting: a mesh of any shape run by
one rank's program with no process group, on meta tensors.  Its
collectives return empty meta tensors of their results' shapes; the
differentiable wrappers take it unchanged.  Every collective over more
than one rank, of a real mesh or of the stand-in, is charged to the
active `analysis.cost.CostCounter` by the same code (`_all_reduce`,
`_all_gather`, `_reduce_scatter`): its kind and its result's bytes on
this rank, the ops that move it counting nothing; so a real rank's
count of a step equals the stand-in's count of that rank's step.
`launch.perf` counts a step on the production mesh's shape so.

The collectives are differentiable: on a tensor that requires grad
(under grad mode) each runs as a `torch.autograd.Function` whose
backward is its transpose on the same group, so a loss summed over the
ranks' terms gets each rank's gradient terms from one backward a rank:
`all_gather`'s backward is `reduce_scatter` along the same dim,
`reduce_scatter`'s is `all_gather`, `all_reduce` (sum)'s is
`all_reduce` (sum).  Gloo's host staging runs inside the forward and the
backward alike.  `all_reduce(op="max")` has no such transpose and takes
only tensors that need no grad (raises otherwise).  On a tensor that
needs no grad a collective is the plain call, as before.

`spawn` starts a job for tests, `chip_smoke.py` and examples: one spawned
process a rank, rendezvous through a file in a temporary directory (no TCP
port, so concurrent jobs never collide), a timeout on every group, a
deadline on the whole job; it raises if a rank fails or outlives it and
returns each rank's return value.
"""
from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import cost
from repro_torch.tree_util import tree_map

__all__ = ["Mesh", "CountingMesh", "make_host_mesh", "make_production_mesh",
           "card_world", "spawn", "world", "flat_axes", "GROUP_TIMEOUT_S"]

GROUP_TIMEOUT_S = 300.0      # every process group's collective timeout

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def flat_axes(axes) -> tuple[str, ...]:
    """An axis name, a tuple of them (nested tuples flattened) or None, as
    a flat tuple of names."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(a for t in axes for a in flat_axes(t))


class Mesh:
    """Axes named over the world's ranks: `Mesh({"data": 2, "model": 2})`.

    `shape` maps each axis to its size and `axis_names` keeps their order,
    as a JAX mesh's do; `size` is the number of ranks and `coords` this
    rank's coordinate on each axis."""

    def __init__(self, axes: dict):
        self._axes(axes)
        n, rank = world()
        if self.size > n:
            raise ValueError(
                f"a mesh of {self.shape} needs {self.size} ranks, but the "
                f"world has {n}" + ("" if n > 1 else
                                    " (no process group is initialised)"))
        self.world_size = n
        self.backend = dist.get_backend() if n > 1 else None
        self._place(rank)

    def _axes(self, axes: dict) -> None:
        self.shape = {str(a): int(n) for a, n in dict(axes).items()}
        self.axis_names = tuple(self.shape)
        if any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes need sizes >= 1, got {self.shape}")
        self.size = math.prod(self.shape.values())
        self._groups: dict[tuple, tuple] = {}

    def _place(self, rank: int) -> None:
        """This rank's coordinates: None outside the mesh."""
        self.rank = rank
        self.member = rank < self.size
        self.coords = None
        if self.member:
            sizes = tuple(self.shape.values())
            self.coords = dict(zip(self.axis_names, (
                int(c) for c in np.unravel_index(rank, sizes))))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")

    def _check(self, axes) -> tuple[str, ...]:
        if not self.member:
            raise ValueError(f"rank {self.rank} lies outside the mesh "
                             f"{self.shape} of ranks 0-{self.size - 1}")
        names = flat_axes(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not one of the mesh's "
                                 f"{self.axis_names}")
        return names

    def axis_size(self, axes) -> int:
        """Ranks along `axes` (an axis, or a tuple of axes: the product)."""
        return math.prod(self.shape[a] for a in self._check(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along `axes`, row-major over a tuple."""
        idx = 0
        for a in self._check(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _rank_of(self, coords: dict) -> int:
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names),
            tuple(self.shape.values())))

    def _group(self, names: tuple[str, ...]):
        """(process group, its members ordered by index along `names`)
        of this rank's group along `names`, made at its first use.  On a
        mesh that spans the world every rank makes every group along
        `names`, in one order; on a smaller one each member makes its own
        group alone, with its peers (`use_local_synchronization`)."""
        if names in self._groups:
            return self._groups[names]
        rest = [a for a in self.axis_names if a not in names]
        whole = self.size == self.world_size
        mine = None
        for fixed in np.ndindex(*(self.shape[a] for a in rest)):
            base = dict(zip(rest, fixed))
            members = [self._rank_of({**base, **dict(zip(names, idx))})
                       for idx in np.ndindex(*(self.shape[a]
                                               for a in names))]
            if not whole and self.rank not in members:
                continue
            if len(members) == self.world_size:
                group = dist.group.WORLD
            else:
                group = dist.new_group(
                    sorted(members),
                    timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                    use_local_synchronization=not whole)
            if self.rank in members:
                mine = (group, members)
        self._groups[names] = mine
        return mine

    def barrier(self) -> None:
        """Wait for every rank of the mesh (none without a group)."""
        if self.size > 1:
            dist.barrier(group=self._group(self._check(self.axis_names))[0])

    def _staged(self, x: torch.Tensor, own: bool = False):
        """(the tensor the collective takes: x, or a copy of it where
        `own` or where gloo stages a CUDA tensor through the host, a
        function allocating a receive buffer like it, a function putting
        a result back on x's device).  The host copies are pinned, so
        that both copies run at the link's rate."""
        if self.backend == "nccl" and x.device.type != "cuda":
            raise ValueError(f"an NCCL mesh takes CUDA tensors, not a "
                             f"tensor on {x.device}")
        if self.backend == "gloo" and x.device.type == "cuda":
            def pinned(t):
                return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf = pinned(x)
            buf.copy_(x.detach())
            return buf, pinned, lambda y: y.to(x.device)
        buf = x.detach()
        return (buf.clone() if own else buf), torch.empty_like, lambda y: y

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (or max) of x over the ranks along `axes`, on every one
        of them; x is not changed.  Differentiable (the sum only)."""
        names = self._check(axes)
        if op not in _OPS:
            raise ValueError(f"op {op!r}: expected one of {sorted(_OPS)}")
        if _tracked(x):
            if op != "sum":
                raise ValueError(
                    f"all_reduce(op={op!r}) has no gradient: give it a "
                    f"detached tensor")
            if self.axis_size(names) > 1:
                return _AllReduce.apply(x, self, names)
        return self._all_reduce(x, names, op)

    def _all_reduce(self, x, names, op="sum"):
        if self.axis_size(names) == 1:
            return x.clone()
        return self._charged("all-reduce", self._move_all_reduce, x, names,
                             op)

    @staticmethod
    def _charged(kind: str, move, *args) -> torch.Tensor:
        """`move(*args)`, the ops it runs counting nothing, charged to the
        active counters as one collective of `kind`."""
        with cost.uncounted():
            out = move(*args)
        cost.collective(kind, out)
        return out

    def _move_all_reduce(self, x, names, op):
        group, _ = self._group(names)
        buf, _, back = self._staged(x, own=True)
        buf = buf.contiguous()
        dist.all_reduce(buf, op=_OPS[op], group=group)
        return back(buf)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' x along `axes` concatenated along `dim`, in their
        order along `axes` (the block of index i at the i-th place).
        Differentiable."""
        names = self._check(axes)
        if self.axis_size(names) == 1:
            return x.clone()
        if _tracked(x):
            return _AllGather.apply(x, self, names, dim)
        return self._all_gather(x, names, dim)

    def _all_gather(self, x, names, dim):
        return self._charged("all-gather", self._move_all_gather, x, names,
                             dim)

    def _move_all_gather(self, x, names, dim):
        group, members = self._group(names)
        buf, empty, back = self._staged(x)
        buf = buf.contiguous()
        parts = [empty(buf) for _ in members]
        dist.all_gather(parts, buf, group=group)
        # all_gather fills by group rank, i.e. by ascending global rank
        by_rank = dict(zip(sorted(members), parts))
        return torch.cat([back(by_rank[r]) for r in members], dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        """This rank's block along `dim` of the sum of x over the ranks
        along `axes`: the block of index i (the i-th of `axis_size(axes)`
        equal blocks) on the rank of index i, as `all_gather` puts them
        back.  NCCL runs the native collective; gloo has none for every
        dtype and device, so there it is `all_reduce` followed by this
        rank's slice.  Differentiable."""
        names = self._check(axes)
        n = self.axis_size(names)
        if x.shape[dim] % n:
            raise ValueError(f"a dimension of {x.shape[dim]} does not split "
                             f"over {names} ({n} ranks)")
        if n == 1:
            return x.clone()
        if _tracked(x):
            return _ReduceScatter.apply(x, self, names, dim)
        return self._reduce_scatter(x, names, dim)

    def _reduce_scatter(self, x, names, dim):
        return self._charged("reduce-scatter", self._move_reduce_scatter, x,
                             names, dim)

    def _move_reduce_scatter(self, x, names, dim):
        size = x.shape[dim] // self.axis_size(names)
        i = self.axis_index(names)
        group, members = self._group(names)
        if self.backend != "nccl":
            buf, _, back = self._staged(x, own=True)
            buf = buf.contiguous()
            dist.all_reduce(buf, group=group)
            return back(buf.narrow(dim, i * size, size)).contiguous()
        buf, _, back = self._staged(x)
        # the group's ranks take the blocks in ascending global rank
        order = sorted(members)
        parts = [t.contiguous() for t in buf.split(size, dim=dim)]
        ins = [parts[members.index(r)] for r in order]
        out = torch.empty_like(ins[0])
        dist.reduce_scatter(out, ins, group=group)
        return back(out)


class CountingMesh(Mesh):
    """A stand-in for counting: a mesh of `axes` whose program is rank
    `rank`'s, with no process group, on meta tensors (see the module
    docstring).  Each collective returns an empty meta tensor of its
    result's shape and is charged as a real mesh's is."""

    def __init__(self, axes: dict, rank: int = 0):
        self._axes(axes)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} lies outside the mesh "
                             f"{self.shape}")
        self.world_size = self.size
        self.backend = None
        self._place(rank)

    @staticmethod
    def _meta(x: torch.Tensor, shape) -> torch.Tensor:
        if x.device.type != "meta":
            raise ValueError(f"a CountingMesh counts meta tensors, not a "
                             f"tensor on {x.device}")
        return x.new_empty(shape)

    def _move_all_reduce(self, x, names, op):
        return self._meta(x, x.shape)

    def _move_all_gather(self, x, names, dim):
        shape = list(x.shape)
        shape[dim] *= self.axis_size(names)
        return self._meta(x, shape)

    def _move_reduce_scatter(self, x, names, dim):
        shape = list(x.shape)
        shape[dim] //= self.axis_size(names)
        return self._meta(x, shape)


def _tracked(x: torch.Tensor) -> bool:
    """Does autograd record an op on x?"""
    return torch.is_grad_enabled() and x.requires_grad


# Each collective's backward is its transpose on the same group, issued
# through the public method (a spy on the mesh's methods counts it; a
# gradient that itself requires grad goes through the Function again).

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return mesh._all_reduce(x, names)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.names), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        return mesh._all_gather(x, names, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.names, ctx.dim), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        return mesh._reduce_scatter(x, names, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g, ctx.names, ctx.dim), None, None,
                None)


def make_host_mesh(data: int = 2, model: int = 4) -> Mesh:
    """A (data, model) mesh over the world's ranks (tests)."""
    return Mesh({"data": data, "model": model})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods x
    256 as (pod=2, data=16, model=16); `pod` composes with `data` for data
    parallelism.  Raises unless the world has exactly that many ranks."""
    axes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    need = math.prod(axes.values())
    n, _ = world()
    if n != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {axes} needs {need} ranks; the world has {n}")
    return Mesh(axes)


def card_world(max_world: int = 4) -> tuple[int, str]:
    """(ranks, backend) for a job on this machine's cards: one rank a card
    over NCCL, up to `max_world`, where there are two or more cards; two
    ranks sharing the one card over gloo otherwise."""
    if not torch.cuda.is_available():
        raise RuntimeError("card_world needs a CUDA card")
    cards = torch.cuda.device_count()
    if cards >= 2:
        return min(max_world, cards), "nccl"
    return 2, "gloo"


def _rank_main(rank: int, fn, n: int, backend: str, tmp: str,
               timeout: float, args) -> None:
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(*args)
        dist.barrier()
    except BaseException:
        # the first failure, stamped, for `spawn` to report (the other
        # ranks then fail in their collectives)
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\nrank {rank}: "
                    f"{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()
    cpu = tree_map(lambda x: x.detach().cpu()
                   if isinstance(x, torch.Tensor) else x, out)
    torch.save(cpu, os.path.join(tmp, f"rank{rank}.pt"))


def _failures(tmp: str, n: int) -> str:
    """The failed ranks' tracebacks, the earliest first."""
    errs = []
    for r in range(n):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                stamp, text = f.read().split("\n", 1)
            errs.append((float(stamp), text))
    return "\n".join(text for _, text in sorted(errs))


def spawn(fn, n: int, args: tuple = (), *, backend: str = "gloo",
          timeout: float = 600.0) -> list:
    """Run `fn(*args)` on `n` spawned ranks of one process group and
    return their return values in rank order (tensors moved to the CPU).

    `fn` must be importable by name (a module-level function); `args` go
    to every rank (CUDA tensors through CUDA IPC: no copy on the same
    card; keep them alive until this returns).  Each group times out
    after `timeout` seconds, and so does the job: a rank that raises,
    dies or outlives the deadline fails it (the others are stopped) and
    this raises."""
    import torch.multiprocessing as mp
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: expected gloo or nccl")
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, backend, tmp, timeout, args),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks of {getattr(fn, '__name__', fn)} did "
                        f"not finish within {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_failures(tmp, n) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
