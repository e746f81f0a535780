"""Device meshes over ``torch.distributed``: port of ``repro/launch/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over the devices of one
process and runs each sharded function once for the whole mesh
(``shard_map``).  Here every device is a process (a *rank*) that runs the
same program on its own shard (SPMD), and a :class:`Mesh` is that rank's
view of the logical device grid:

  * ranks are laid out row-major over the axes, as ``jax.make_mesh`` lays
    out its devices: on a ``(data 2, model 4)`` mesh rank 6 sits at
    ``data 1, model 2``;
  * every non-empty set of axes has a process group of the ranks that
    differ only along those axes (``Mesh.group``), built once when the mesh
    is made; within a group the ranks are ordered row-major over its axes,
    so a tiled all-gather over ``("data", "model")`` lays the blocks out as
    ``PartitionSpec(("data", "model"))`` does.

The differentiable collectives (:func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`) are ``torch.autograd.Function``s whose backward is
the transposed collective on the cotangent: all-reduce <-> all-reduce,
all-gather <-> reduce-scatter.  Each rank's cotangent must cover only what
that rank's loss used (a replicated value is consumed once over the mesh,
``models.recsys.dense_shard``): the all-reduce's backward sums the ranks'
cotangents.  Tensor parallelism, where every rank holds a replicated
value's whole cotangent, takes the conjugate pair instead: :func:`copy_to`
(identity; all-reduce backward) and :func:`reduce_from` (all-reduce;
identity backward).

Every call adds the bytes one device moves under the ring model of the
reference's ``launch/hlo_analysis.py`` to ``comm.bytes.<op>``, and one to
``comm.calls.<op>``, in the process's metrics registry, backward calls
included, and reports the call to ``kernels.work`` (the dry run's trace):

    all-reduce      2 * bytes * (G-1)/G     (a sum; a max counts apart,
                                            as all_reduce_max, alike)
    all-gather      out_bytes * (G-1)/G
    reduce-scatter  out_bytes * G * (G-1)/G      (input-sized)

With the gloo backend a CUDA tensor is staged through host memory; a time
taken so measures the host, not an interconnect.

A :class:`DryMesh` is one rank of a mesh with no processes behind it, for
the dry run (``launch.dryrun``): its collectives take ``meta`` tensors
only, send nothing, return a meta tensor of the shape the real collective
returns, and count as the real ones do.  A real :class:`Mesh` refuses a
meta tensor and a ``DryMesh`` any other; neither falls back to the other.

:func:`spawn` runs a function on N ranks of this host (``torch.multiprocessing``,
rendezvous through a ``FileStore`` file, never a TCP port) and returns
what each rank returned.
"""
from __future__ import annotations

import itertools
import math
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.sharding import AXIS_DATA, AXIS_MODEL, AXIS_POD, PartitionSpec
from repro_torch.kernels import work
from repro_torch.obs.metrics import get_registry

PRODUCTION_SHAPES = {False: ((16, 16), (AXIS_DATA, AXIS_MODEL)),
                     True: ((2, 16, 16), (AXIS_POD, AXIS_DATA, AXIS_MODEL))}
SPAWN_TIMEOUT_S = 600.0


class Mesh:
    """This rank's coordinates and process groups on a device mesh.

    ``torch.distributed`` must be initialised with a world of
    ``prod(shape)`` ranks; every rank makes the same mesh (the groups are
    made collectively).  ``shape`` maps axis names to sizes, in order, as
    ``jax.sharding.Mesh.shape``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError("one size per axis name")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of {tuple(shape)} = {math.prod(shape)} devices "
                             f"needs that many ranks; the world has {world}")
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised (launch.mesh.spawn)")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(self.rank, shape))))
        grid = np.arange(world).reshape(shape)
        self._groups: dict[tuple[str, ...], Any] = {}
        for k in range(1, len(shape) + 1):
            for axes in itertools.combinations(range(len(shape)), k):
                rest = [d for d in range(len(shape)) if d not in axes]
                # ranks differing only along `axes`, one group per position elsewhere
                blocks = np.transpose(grid, rest + list(axes)).reshape(-1, math.prod(
                    shape[d] for d in axes))
                for ranks in blocks:
                    g = dist.new_group(sorted(int(r) for r in ranks))
                    if self.rank in ranks:
                        self._groups[tuple(self.axis_names[d] for d in axes)] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or names) in the mesh's order; unknown names raise."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh {tuple(self.shape)}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def index(self, axes) -> int:
        """This rank's linear position over ``axes``, row-major in the given
        order (the block it holds of a dimension split over them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.axes(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes) -> tuple[int, ...]:
        """The global ranks of the group over ``axes`` that holds this rank,
        in the group's (row-major) order."""
        axes = self.axes(axes)
        sizes = tuple(self.shape.values())
        ranks = []
        for pos in itertools.product(*(range(self.shape[a]) for a in axes)):
            coords = dict(self.coords, **dict(zip(axes, pos)))
            ranks.append(int(np.ravel_multi_index(tuple(coords[a] for a in self.axis_names),
                                                  sizes)))
        return tuple(ranks)

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        return self._groups[self.axes(axes)]

    def barrier(self) -> None:
        dist.barrier()


class DryMesh(Mesh):
    """Rank ``rank`` of a mesh of ``shape`` with no processes and no process
    group behind it: the dry run's stand-in for one rank of the production
    mesh.  It has a real mesh's ``shape``, ``axis_names``, ``coords`` and
    layout methods, so ``block_slices`` and ``models.recsys.shard_params``
    cut that rank's blocks unchanged; its collectives take meta tensors
    only (``_all_reduce_raw`` and the rest)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], rank: int = 0):
        if len(shape) != len(axis_names):
            raise ValueError("one size per axis name")
        if not 0 <= rank < math.prod(shape):
            raise ValueError(f"rank {rank} outside a mesh of {math.prod(shape)} devices")
        self.shape = dict(zip(axis_names, (int(n) for n in shape)))
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.backend = None
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, shape))))
        self._groups = {}

    def __repr__(self) -> str:
        return f"DryMesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def group(self, axes):
        raise RuntimeError("a DryMesh has no process groups: its collectives send nothing")

    def barrier(self) -> None:
        raise RuntimeError("a DryMesh has no processes to wait for")


class AbstractMesh:
    """A mesh's shape and axis names with no ranks behind it: the
    counterpart of ``repro.compat.abstract_mesh``.  It describes a layout
    (the 16x16 production pod) to code that only reads ``shape``,
    ``axis_names`` and ``axis_size``, such as the config registry's cell
    builds; it has no coordinates, groups or collectives."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError("one size per axis name")
        self.shape = dict(zip(axis_names, (int(n) for n in shape)))
        self.axis_names = tuple(axis_names)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh {tuple(self.shape)}")
        return math.prod(self.shape[a] for a in axes)


def make_debug_mesh(data: int = 2, model: int = 4, pod: int | None = None) -> Mesh:
    """A small mesh for CPU tests and one-card runs: ``(data, model)`` or
    ``(pod, data, model)``."""
    if pod:
        return Mesh((pod, data, model), (AXIS_POD, AXIS_DATA, AXIS_MODEL))
    return Mesh((data, model), (AXIS_DATA, AXIS_MODEL))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 (512, 2 pods).  A world of
    any other size raises: the mesh is never shrunk to fit."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return Mesh(shape, axes)


def batch_axes_for(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in (AXIS_POD, AXIS_DATA))


# ------------------------------------------------------------------- layouts


def block_slices(shape: Sequence[int], spec: PartitionSpec | None, mesh: Mesh,
                 have: PartitionSpec | None = None) -> tuple[slice, ...]:
    """The slices of an array of ``shape`` that this rank holds under
    ``spec``, when the array is already split as ``have`` (a prefix of each
    dimension's axes in ``spec``; default: not split)."""
    out = []
    for d, n in enumerate(shape):
        want = spec.axes_of(d) if spec is not None else ()
        got = have.axes_of(d) if have is not None else ()
        if want[:len(got)] != got:
            raise ValueError(f"dim {d}: split over {got}, which does not lead {want}")
        rest = want[len(got):]
        if not rest:
            out.append(slice(None))
            continue
        parts = mesh.axis_size(rest)
        if n % parts:
            raise ValueError(f"dim {d} of {n} does not split {parts} ways over {rest}")
        step = n // parts
        i = mesh.index(rest)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


# --------------------------------------------------------------- collectives


def _count(op: str, nbytes: float, out: torch.Tensor, mesh: Mesh, axes) -> None:
    reg = get_registry()
    reg.counter(f"comm.bytes.{op}").add(nbytes)
    reg.counter(f"comm.calls.{op}").add(1)
    work.collective(op, nbytes, out.numel() * out.element_size(), mesh.group_ranks, axes)


def _dry(mesh: Mesh, x: torch.Tensor) -> bool:
    """Whether this collective is the dry run's: a ``DryMesh`` and a meta
    tensor.  Either without the other raises."""
    dry = isinstance(mesh, DryMesh)
    if dry != (x.device.type == "meta"):
        raise ValueError(f"a {type(mesh).__name__} takes "
                         f"{'meta tensors only' if dry else 'no meta tensor'}; got one on "
                         f"{x.device}")
    return dry


def ring_bytes(op: str, nbytes: int, group_size: int) -> float:
    """Per-device bytes of one collective under the ring model: ``nbytes``
    is the all-reduce's tensor, the all-gather's output or the
    reduce-scatter's output on one device."""
    g = group_size
    if op in ("all_reduce", "all_reduce_max"):
        return 2 * nbytes * (g - 1) / g
    if op == "all_gather":
        return nbytes * (g - 1) / g
    if op == "reduce_scatter":
        return nbytes * (g - 1)
    raise ValueError(op)


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _all_reduce_raw(x: torch.Tensor, axes, mesh: Mesh, op=dist.ReduceOp.SUM,
                    counter: str = "all_reduce") -> torch.Tensor:
    g = mesh.axis_size(axes)
    dry = _dry(mesh, x)
    _count(counter, ring_bytes(counter, x.numel() * x.element_size(), g), x, mesh, axes)
    if _staged(mesh, x):
        h = x.detach().to("cpu", copy=True)
        dist.all_reduce(h, op=op, group=mesh.group(axes))
        return h.to(x.device)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if not dry:
        dist.all_reduce(out, op=op, group=mesh.group(axes))
    return out


def all_reduce_max(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks along ``axes`` (the
    reference's ``pmax``), with no gradient: the sequence-sharded decode's
    row maxima.  Its bytes count under ``comm.bytes.all_reduce_max``."""
    return _all_reduce_raw(x, mesh.axes(axes), mesh, dist.ReduceOp.MAX, "all_reduce_max")


def _all_gather_raw(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    g = mesh.axis_size(axes)
    dry = _dry(mesh, x)
    x = x.detach().contiguous()
    out = torch.empty((x.shape[0] * g,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device="cpu" if _staged(mesh, x) else x.device)
    _count("all_gather", ring_bytes("all_gather", out.numel() * out.element_size(), g),
           out, mesh, axes)
    if dry:
        return out
    dist.all_gather_into_tensor(out, x.cpu() if _staged(mesh, x) else x, group=mesh.group(axes))
    return out.to(x.device)


def _reduce_scatter_raw(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    g = mesh.axis_size(axes)
    if x.shape[0] % g:
        raise ValueError(f"reduce_scatter: dim 0 of {x.shape[0]} does not split {g} ways")
    dry = _dry(mesh, x)
    x = x.detach().contiguous()
    out = torch.empty((x.shape[0] // g,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device="cpu" if _staged(mesh, x) else x.device)
    _count("reduce_scatter", ring_bytes("reduce_scatter", out.numel() * out.element_size(), g),
           out, mesh, axes)
    if dry:
        return out
    dist.reduce_scatter_tensor(out, x.cpu() if _staged(mesh, x) else x, group=mesh.group(axes))
    return out.to(x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _all_reduce_raw(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.axes, ctx.mesh), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.axes, ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _all_reduce_raw(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _all_gather_raw(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_raw(g, ctx.axes, ctx.mesh), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _reduce_scatter_raw(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_raw(g, ctx.axes, ctx.mesh), None, None


def _along(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    if dim == 0:
        return fn(x)
    return fn(x.movedim(dim, 0)).movedim(0, dim)


def all_reduce(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axes`` (the reference's ``psum``)."""
    return _AllReduce.apply(x, mesh.axes(axes), mesh)


def copy_to(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """``x``, replicated over ``axes``, handed to computations that each
    rank runs on its own part of the work (a column-parallel product): the
    identity, whose backward all-reduces the ranks' partial cotangents over
    ``axes`` (Megatron's ``f``)."""
    return _CopyTo.apply(x, mesh.axes(axes), mesh)


def reduce_from(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The sum of the ranks' partials ``x`` over ``axes`` as a value
    replicated there (after a row-parallel product): an all-reduce whose
    backward passes the cotangent through, since every rank holds the
    replicated value's whole cotangent (Megatron's ``g``).  :func:`all_reduce`
    also all-reduces the cotangent, which is right only where each rank's
    cotangent is a share of it."""
    return _ReduceFrom.apply(x, mesh.axes(axes), mesh)


def all_gather(x: torch.Tensor, axes, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The blocks of the ranks along ``axes`` concatenated along ``dim`` in
    the group's row-major order (``all_gather(..., tiled=True)``)."""
    axes = mesh.axes(axes)
    return _along(lambda t: _AllGather.apply(t, axes, mesh), x, dim)


def reduce_scatter(x: torch.Tensor, axes, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The sum over the ranks along ``axes``, of which each keeps its block
    along ``dim`` (``psum_scatter(..., tiled=True)``)."""
    axes = mesh.axes(axes)
    return _along(lambda t: _ReduceScatter.apply(t, axes, mesh), x, dim)


def comm_bytes() -> dict:
    """``{op: bytes}`` counted so far by this process's collectives."""
    return _comm("bytes")


def comm_calls() -> dict:
    """``{op: calls}`` counted so far by this process's collectives."""
    return _comm("calls")


def _comm(what: str) -> dict:
    snap = get_registry().snapshot()
    head = f"comm.{what}."
    return {k[len(head):]: v for k, v in snap.items() if k.startswith(head)}


# --------------------------------------------------------------------- spawn


def _rank_main(rank: int, fn: Callable, world: int, init_file: str, queue,
               boxed_args: list) -> None:
    # the process object keeps its arguments until the interpreter exits: the
    # box is emptied here, so the rank drops its views of the caller's CUDA
    # tensors when ``fn`` returns and the caller can free them
    args = boxed_args.pop()
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        # every rank has connected before any runs fn: a rank that fails at
        # once must not break a peer's connect and hide its own error
        dist.barrier()
        result = fn(rank, world, *args)
        del args
        queue.put((rank, pickle.dumps(result)))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), *,
          timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``nprocs`` new processes with
    ``torch.distributed`` initialised (gloo, rendezvous in a fresh
    ``FileStore`` file) and return each rank's result, in rank order.
    ``fn`` must be importable by name; its results are pickled (return
    host objects).  A rank that raises re-raises here; past ``timeout``
    seconds every rank is killed and ``TimeoutError`` raised.  CUDA
    tensors in ``args`` reach the ranks as views of the same memory, which
    every rank has let go of when this returns.

    Keep ``args`` small: they go down each rank's pipe, which the rank reads
    only after importing the main module, so an argument larger than the
    pipe's buffer holds up the start of the next rank (pass a path, or a
    CUDA tensor, whose pickle is a handle)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    init_file = os.path.join(tmp, "store")
    results: dict[int, Any] = {}
    pc = mp.start_processes(_rank_main, args=(fn, nprocs, init_file, queue, [args]),
                            nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while True:
            while not queue.empty():
                r, payload = queue.get()
                results[r] = pickle.loads(payload)
            if pc.join(timeout=0.05):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: {nprocs} ranks of {fn.__name__} still "
                                   f"running after {timeout:.0f}s; killed")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    while not queue.empty():
        r, payload = queue.get()
        results[r] = pickle.loads(payload)
    missing = [r for r in range(nprocs) if r not in results]
    if missing:
        raise RuntimeError(f"spawn: ranks {missing} returned nothing")
    return [results[r] for r in range(nprocs)]
