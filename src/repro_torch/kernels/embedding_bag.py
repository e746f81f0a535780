"""Kernel K1: fused embedding bag (gather + weighted pool), CUDA for Hopper.

Port of ``repro/kernels/embedding_bag.py::embedding_bag``; the source and its
design note are ``csrc/embedding_bag.cu``.  ``embedding_bag`` launches the
kernel on CUDA tensors only; ``ops.embedding_bag`` routes a CPU tensor to the
plain version (``ref.embedding_bag_ref``).  Two modes, one source: weighted
(every row times its weight, the Pallas kernel's contract) and ``masked``
(zero-weight slots skipped, their rows never loaded).  ``launch_plan`` is
the launch geometry, computed here on the host.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Callable

import torch

from repro_torch.kernels import build

NAME = "embedding_bag"
THREADS = 256  # threads a block (kThreads in the source)
NNZ_SPECIALISED = (1, 2, 4, 8)  # nnz values with an unrolled slot loop
_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p,
]
_OCC_ARGS = [ctypes.c_int] * 3
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SYMBOLS = {dt: f"{NAME}_{s}" for dt, s in _DTYPES.items()}
_OCC_SYMBOLS = {dt: f"{NAME}_occupancy_{s}" for dt, s in _DTYPES.items()}
_SIGNATURES = {**{s: _ARGS for s in _SYMBOLS.values()},
               **{s: _OCC_ARGS for s in _OCC_SYMBOLS.values()}}
_WIDE_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_masked = 0  # those of them in the masked mode

_occupancy: dict[tuple, int] = {}  # blocks an SM holds, by resident_blocks' key
_occupancy_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    vec: int  # elements a lane loads at once (16 bytes, or 1)
    lanes: int  # threads spanning a row: its vectors rounded up to a power of two, <= 32
    nnz_spec: int  # the unrolled slot count, or 0 for the general loop
    pass_bags: int  # consecutive bags a group takes a pass (K3's unrolled path; else 1)
    blocks: int  # at most one wave of resident blocks; the kernel strides over bags


def vec_width(dtype: torch.dtype, dim: int, aligned: bool) -> int:
    """16-byte vectors where the row width and the pointers allow, else 1."""
    wide = _WIDE_VEC[dtype]
    return wide if aligned and dim % wide == 0 else 1


def launch_plan(num_bags: int, nnz: int, dim: int, vec: int,
                resident: Callable[[int], int], pass_floats: int = 0) -> LaunchPlan:
    """The geometry of K1 and K3: a group of ``lanes`` threads spans a row,
    ``THREADS // lanes`` groups share a block.  ``nnz`` in
    ``NNZ_SPECIALISED`` (and no larger than ``lanes``) takes the unrolled
    path; K3's (``pass_floats`` f32 sums a lane) takes ``pass_bags``
    consecutive bags a pass, one slot a lane, as many as its lanes and
    sums allow; K1 and the general loop take one bag a pass.  The grid is
    the passes' blocks, capped at one wave of ``resident(nnz_spec)`` blocks
    (SMs times the blocks of that kernel an SM holds), over which the
    kernel strides."""
    nvec = dim // vec
    lanes = 1
    while lanes < min(nvec, 32):
        lanes *= 2
    nnz_spec = nnz if vec > 1 and nnz in NNZ_SPECIALISED and nnz <= lanes else 0
    pass_bags = max(1, min(pass_floats // vec, lanes // nnz)) if nnz_spec else 1
    need = -(-num_bags // (THREADS // lanes * pass_bags))
    return LaunchPlan(vec, lanes, nnz_spec, pass_bags,
                      max(1, min(need, resident(nnz_spec))))


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_blocks(lib, name: str, symbol: str, device: torch.device, *args) -> int:
    """The blocks of one kernel that the card holds at once: SMs times the
    library's occupancy query ``symbol(*args)``, asked once per (library
    file, symbol, device, args).  Used by K1 and K3."""
    key = (getattr(lib, "_name", None), symbol, device, args)
    with _occupancy_lock:
        n = _occupancy.get(key)
        if n is None:
            n = getattr(lib, symbol)(*args)
            if n <= 0:
                build.check(lib, name, -n or 1)
            _occupancy[key] = n
    return sm_count(device) * n


def embedding_bag(
    table: torch.Tensor,  # [V, D] f32 | bf16, CUDA, contiguous
    indices: torch.Tensor,  # [N] int32, N = num_bags * nnz
    weights: torch.Tensor,  # [N] f32
    num_bags: int,
    masked: bool = False,
) -> torch.Tensor:
    """``[num_bags, D]`` f32 weighted bag sums, computed by kernel K1; with
    ``masked`` the zero-weight slots are skipped."""
    global launches, launches_masked
    if not _on_cuda(table):
        raise ValueError(
            f"{NAME} kernel takes CUDA tensors, got {table.device}; "
            "ops.embedding_bag routes CPU tensors to the plain version"
        )
    if table.dtype not in _SYMBOLS:
        raise TypeError(f"{NAME}: table dtype {table.dtype} not in f32/bf16")
    if table.dim() != 2 or indices.dim() != 1 or weights.shape != indices.shape:
        raise ValueError(
            f"{NAME}: want table [V,D], indices [N], weights [N]; got "
            f"{tuple(table.shape)}, {tuple(indices.shape)}, {tuple(weights.shape)}"
        )
    if indices.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"{NAME}: indices must be int32 and weights f32")
    for name, t in (("table", table), ("indices", indices), ("weights", weights)):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous on {table.device}")
    N = indices.shape[0]
    if num_bags <= 0 or N % num_bags:
        raise ValueError(f"{NAME}: fixed-nnz layout required (N={N}, bags={num_bags})")
    V, D = table.shape
    if V == 0 or D == 0:
        raise ValueError(f"{NAME}: empty table {tuple(table.shape)}")
    out = torch.empty((num_bags, D), dtype=torch.float32, device=table.device)
    lib = build.load(NAME, _SIGNATURES)
    nnz = N // num_bags
    vec = vec_width(table.dtype, D, (table.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(table.device):
        plan = launch_plan(num_bags, nnz, D, vec, lambda spec: resident_blocks(
            lib, NAME, _OCC_SYMBOLS[table.dtype], table.device, vec, spec, int(masked)))
        code = getattr(lib, _SYMBOLS[table.dtype])(
            table.data_ptr(), indices.data_ptr(), weights.data_ptr(),
            out.data_ptr(), num_bags, nnz, D, V, plan.vec, plan.lanes,
            plan.nnz_spec, int(masked), plan.blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, NAME, code)
    launches += 1
    launches_masked += int(masked)
    return out
