"""Roofline terms of one rank's step, from a trace of its operators.

Port of ``repro/launch/hlo_analysis.py``.  The reference parses the
optimized HLO that XLA compiled; PyTorch compiles nothing, so there is no
HLO here.  :class:`Trace` instead watches the step run, on the ``meta``
device in the dry run (``launch.dryrun``) or on the card, and counts:

  * FLOPs: ``torch.utils.flop_counter``'s formulas for every aten op it
    knows (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``, ...):
    2 x |out| x K, as the reference's ``_dot_flops``, by the operands'
    dtype class (``bf16`` for bf16/f16, ``f32`` otherwise: the port keeps
    TF32 off);
  * memory bytes: each op's operand and output bytes, the reference's
    post-fusion proxy (PyTorch runs every op as its own kernel, so the
    proxy is what it moves).  Views, ``empty`` and ``detach`` move
    nothing, as the reference skips ``bitcast``, ``tuple`` and
    ``parameter``; an in-place op's output is its operand, counted once; a
    copy from host memory is a host transfer and counts nothing.
    Gathers count their whole operand, the reference's acknowledged
    overcount;
  * the hand kernels' launches and work (``kernels.work``: each wrapper
    reports what its own formula reckons from the shapes, on the card and
    on meta alike; a kernel's aten-free launch is seen only so);
  * the collectives' calls and ring-model bytes (``launch.mesh``), each
    call's result bytes also counted as memory, as the reference does (on
    the card a collective's staging copies are aten ops and count too);
  * peak live bytes: the most bytes of storages created by the step that
    were alive at once (each freed when its last reference goes: a weak
    reference to the storage), the counterpart of ``temp_size_in_bytes``.
    Every op's new device storage counts, ``empty``'s and a host copy's
    too: the hand kernels' outputs and the collectives' results are made
    so.  Host storages do not count, nor do a library's own workspaces, nor
    the scratch a kernel keeps per stream across steps (K1''s grouping
    tables, K4's winner table, K7's workspace: made once, on the card
    only).

Hardware model, NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit; not measured): 989 TFLOP/s bf16, 495 TFLOP/s TF32 (three
products a 3xTF32 product), 67 TFLOP/s f32 outside the tensor cores,
3.35 TB/s and 80 GB of HBM.  Collectives: NVLink 4's 900 GB/s a GPU on
the data sheet, 450 GB/s a direction, for a group whose ranks sit in one
node of 8 consecutive ranks (an HGX/DGX H100 board); a group that spans
nodes moves at 50 GB/s a GPU, one 400 Gb/s InfiniBand NDR port a GPU as in
a DGX H100.  A call runs at its group's slowest link.  The ring model is
``launch.mesh.ring_bytes``'s.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}  # FLOP/s, H100 SXM data sheet
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80e9
NVLINK_BW = 450e9  # B/s a direction a GPU, within a node
NODE_BW = 50e9  # B/s a GPU across nodes: one 400 Gb/s NDR port
NODE_GPUS = 8

_aten = torch.ops.aten
# ops that allocate without writing: live storage, no bytes moved
_ALLOCS = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
           _aten.new_empty.default, _aten.new_empty_strided.default}
# ops that alias their input (as views do): no bytes, no storage
_ALIASES = {_aten.detach.default, _aten.alias.default, _aten.lift_fresh.default,
            _aten._unsafe_view.default}


def _from_host(func, args, out) -> bool:
    """A copy from host memory onto the device: a host transfer, not HBM
    traffic (on the card a tensor constructor's own such copy is not even
    dispatched where the trace sees it)."""
    if func is _aten._to_copy.default:
        src, dst = args[0], out
    elif func is _aten.copy_.default:
        src, dst = args[1], args[0]
    else:
        return False
    return src.device.type == "cpu" and dst.device.type != "cpu"


def product_class(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def link_bw(ranks: tuple[int, ...]) -> float:
    """The bandwidth a collective among the global ``ranks`` runs at: NVLink
    within a node of ``NODE_GPUS`` consecutive ranks, the network across."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 else NODE_BW


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Trace(TorchDispatchMode):
    """Counts what the code run inside ``with Trace() as tr:`` does (see the
    module docstring).  Read ``flops`` (by class), ``mem_bytes``,
    ``kernels`` (``{name: {"launches": n, "bytes": b, class: flops}}``; a
    kernel's mode, such as ``embedding_bag_masked``, counts launches only),
    ``collectives`` (``{op: {"calls": n, "bytes": b, "seconds": s}}``),
    ``peak_bytes``, ``storages`` (how many it saw made), ``aten_flops``
    (the aten ops' part of ``flops``) and
    ``bytes_by_op`` (the aten ops' part of ``mem_bytes``, by overload)."""

    def __init__(self):
        super().__init__()
        self.flops = dict.fromkeys(work.CLASSES, 0.0)
        self.aten_flops = dict.fromkeys(work.CLASSES, 0.0)
        self.mem_bytes = 0.0
        self.bytes_by_op: dict[str, int] = {}  # the aten ops' part of mem_bytes
        self.kernels: dict[str, dict] = {}
        self.collectives: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.created: dict[int, int] = {}  # storage key -> bytes, alive
        self.storages = 0  # storages created, freed or not
        self._lock = threading.RLock()  # a finalizer may run inside a held region

    def __enter__(self):
        work.watch(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.unwatch(self)
        return super().__exit__(*exc)

    # ---------------------------------------------------------- aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            ins = _tensors(args)
            cls = product_class(ins[0].dtype if ins else torch.float32)
            n = float(flop_registry[packet](*args, **kwargs, out_val=out))
            with self._lock:
                self.flops[cls] += n
                self.aten_flops[cls] += n
        if func.is_view or func in _ALIASES:
            return out
        ins = _tensors((args, kwargs))
        outs = [t for t in _tensors(out) if not any(t is i for i in ins)]
        for t in outs:
            self._created(t)
        if func in _ALLOCS or _from_host(func, args, out):
            return out
        n = sum(map(_size, ins)) + sum(map(_size, outs))
        with self._lock:
            self.mem_bytes += n
            self.bytes_by_op[func.__name__] = self.bytes_by_op.get(func.__name__, 0) + n
        return out

    def _created(self, t: torch.Tensor) -> None:
        if t.device.type == "cpu":
            return
        storage = t.untyped_storage()
        key = storage._cdata
        with self._lock:
            if key in self.created:
                return
            n = storage.nbytes()
            self.created[key] = n
            self.storages += 1
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._freed, key)

    def _freed(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self.created.pop(key, 0)

    # ------------------------------------------ hand kernels, collectives
    def on_kernel(self, names: tuple[str, ...], w: work.Work) -> None:
        with self._lock:
            for i, name in enumerate(names):
                k = self.kernels.setdefault(name, {"launches": 0})
                k["launches"] += 1
                if i:
                    continue
                k["bytes"] = k.get("bytes", 0.0) + w.bytes
                self.mem_bytes += w.bytes
                for cls in work.CLASSES:
                    k[cls] = k.get(cls, 0.0) + getattr(w, cls)
                    self.flops[cls] += getattr(w, cls)

    def on_collective(self, op: str, nbytes: float, result_bytes: int,
                      ranks: tuple[int, ...]) -> None:
        with self._lock:
            c = self.collectives.setdefault(op, {"calls": 0, "bytes": 0.0, "seconds": 0.0})
            c["calls"] += 1
            c["bytes"] += nbytes
            c["seconds"] += nbytes / link_bw(ranks)
            self.mem_bytes += result_bytes

    # ----------------------------------------------------------- totals
    def kernel_launches(self) -> dict[str, int]:
        return {name: k["launches"] for name, k in self.kernels.items()}

    def collective_bytes(self) -> dict[str, float]:
        return {op: c["bytes"] for op, c in self.collectives.items()}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_counts: dict

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_counts": self.collective_counts,
            "dominant": self.dominant,
        }


def analyze(trace: Trace) -> RooflineTerms:
    """The roofline terms of one rank's traced step on an H100: each
    product class at its peak, the memory bytes at HBM's rate, each
    collective call at its group's link."""
    return RooflineTerms(
        compute_s=sum(n / PEAK_FLOPS[cls] for cls, n in trace.flops.items()),
        memory_s=trace.mem_bytes / HBM_BW,
        collective_s=sum(c["seconds"] for c in trace.collectives.values()),
        flops_per_device=sum(trace.flops.values()),
        bytes_per_device=trace.mem_bytes,
        collective_bytes_per_device=sum(c["bytes"] for c in trace.collectives.values()),
        collective_counts=_hlo_counts(trace),
    )


def _hlo_counts(trace: Trace) -> dict[str, int]:
    """Calls by the HLO opcode the reference counts them under (a max is an
    all-reduce too)."""
    out: dict[str, int] = {}
    for op, c in trace.collectives.items():
        name = "all-reduce" if op == "all_reduce_max" else op.replace("_", "-")
        out[name] = out.get(name, 0) + c["calls"]
    return out
