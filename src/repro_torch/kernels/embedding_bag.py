"""Kernel K1: fused embedding bag (gather + weighted pool), CUDA for Hopper.

Port of ``repro/kernels/embedding_bag.py::embedding_bag``; the source and its
design note are ``csrc/embedding_bag.cu``.  ``embedding_bag`` launches the
kernel on CUDA tensors only; ``ops.embedding_bag`` routes a CPU tensor to the
plain version (``ref.embedding_bag_ref``).  Two modes, one source: weighted
(every row times its weight, the Pallas kernel's contract) and ``masked``
(zero-weight slots skipped, their rows never loaded).  ``launch_plan`` is
the launch geometry, computed here on the host.

``embedding_bag_backward`` is kernel K1', the table's gradient (same source):
a keys kernel, ``torch.sort`` of the keys, and a kernel that sums each row's
slots in slot order, so the gradient is the same bit for bit on every run.
``ops.embedding_bag`` wires both into autograd for CUDA tables.
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
BWD_KEYS_SYMBOL = f"{NAME}_backward_keys"  # K1'
BWD_SYMBOL = f"{NAME}_backward_f32"
_SIGNATURES = {
    **{s: _ARGS for s in _SYMBOLS.values()},
    **{s: _OCC_ARGS for s in _OCC_SYMBOLS.values()},
    BWD_KEYS_SYMBOL: [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p],
    BWD_SYMBOL: [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
}
_WIDE_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
BWD_BLOCKS_PER_SM = 8  # the backward kernels' grid cap: 8 blocks of 256 threads an SM
MAX_ROWS = 2**31 - 2  # K1' keys are int32, with V itself marking a masked slot

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_masked = 0  # those of them in the masked mode
launches_backward = 0  # K1' launches

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


def row_lanes(dim: int, vec: int) -> int:
    """Threads spanning a row of ``dim`` in vectors of ``vec``: the vectors
    rounded up to a power of two, at most 32."""
    lanes = 1
    while lanes < min(dim // vec, 32):
        lanes *= 2
    return lanes


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
    lanes = row_lanes(dim, vec)
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


def embedding_bag_backward(
    grad_out: torch.Tensor,  # [num_bags, D] f32, CUDA, contiguous
    indices: torch.Tensor,  # [N] int32, N = num_bags * nnz
    weights: torch.Tensor,  # [N] f32
    num_rows: int,
    masked: bool = False,
) -> torch.Tensor:
    """``[num_rows, D]`` f32 gradient of K1's table, kernel K1':
    ``grad[clamp(idx[s])] += w[s] * grad_out[s // nnz]`` in slot order, every
    row no slot names left 0; with ``masked`` a slot whose weight is 0 adds
    nothing and its id is not used."""
    global launches_backward
    if not _on_cuda(grad_out):
        raise ValueError(
            f"{NAME}_backward kernel takes CUDA tensors, got {grad_out.device}; "
            "on the CPU autograd differentiates the plain version"
        )
    if grad_out.dtype != torch.float32 or grad_out.dim() != 2:
        raise TypeError(f"{NAME}_backward: grad_out must be [num_bags, D] f32, got "
                        f"{tuple(grad_out.shape)} {grad_out.dtype}")
    if indices.dtype != torch.int32 or weights.dtype != torch.float32 \
            or indices.dim() != 1 or weights.shape != indices.shape:
        raise TypeError(f"{NAME}_backward: want indices [N] int32 and weights [N] f32")
    for name, t in (("grad_out", grad_out), ("indices", indices), ("weights", weights)):
        if t.device != grad_out.device or not t.is_contiguous():
            raise ValueError(f"{NAME}_backward: {name} must be contiguous on {grad_out.device}")
    num_bags, D = grad_out.shape
    N = indices.shape[0]
    if num_bags <= 0 or N % num_bags or D == 0:
        raise ValueError(f"{NAME}_backward: fixed-nnz layout required (N={N}, "
                         f"bags={num_bags}, D={D})")
    if not 0 < num_rows <= MAX_ROWS:
        raise ValueError(f"{NAME}_backward: {num_rows} rows outside (0, {MAX_ROWS}]")
    grad = torch.zeros((num_rows, D), dtype=torch.float32, device=grad_out.device)
    if N == 0:
        return grad
    lib = build.load(NAME, _SIGNATURES)
    vec = vec_width(torch.float32, D, (grad_out.data_ptr() | grad.data_ptr()) % 16 == 0)
    lanes = row_lanes(D, vec)
    with torch.cuda.device(grad_out.device):
        stream = torch.cuda.current_stream().cuda_stream
        cap = sm_count(grad_out.device) * BWD_BLOCKS_PER_SM
        keys = torch.empty(N, dtype=torch.int32, device=grad_out.device)
        code = getattr(lib, BWD_KEYS_SYMBOL)(
            indices.data_ptr(), weights.data_ptr(), keys.data_ptr(), N, num_rows,
            int(masked), min(-(-N // THREADS), cap), stream)
        build.check(lib, NAME, code)
        keys, perm = torch.sort(keys, stable=True)
        code = getattr(lib, BWD_SYMBOL)(
            grad_out.data_ptr(), keys.data_ptr(), perm.data_ptr(), weights.data_ptr(),
            grad.data_ptr(), N, N // num_bags, D, num_rows, vec, lanes,
            min(-(-N // (THREADS // lanes)), cap), stream)
    build.check(lib, NAME, code)
    launches_backward += 1
    return grad
