"""Kernels K3 (probe + gather + pool + miss mask) and K4 (swap-in scatter).

Port of ``repro/hotcache/kernels.py``; the CUDA sources and their design
notes are ``csrc/probe_gather_pool.cu`` and ``csrc/scatter_update.cu``.
Each entry point dispatches by the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version in
``hotcache/ref.py``, a ``meta`` tensor (the dry run) takes the card's checks
and allocations, then reports ``probe_gather_pool_work`` /
``scatter_update_work`` to ``kernels.work`` and launches nothing (no winner
scratch is kept for it).  ``launches`` counts kernel launches per kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.hotcache import ref
from repro_torch.kernels import build, work
from repro_torch.kernels.embedding_bag import launch_plan, resident_blocks, vec_width
from repro_torch.kernels.ops import _is_cuda, same_device_type

PROBE = "probe_gather_pool"
SCATTER = "scatter_update"

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
PASS_FLOATS = 16  # f32 sums a K3 lane keeps for the bags of one pass (kMaxBags)
_PROBE_ARGS = [ctypes.c_void_p] * 6 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p,
]
_PROBE_OCC_ARGS = [ctypes.c_int] * 2
_SCATTER_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
]
_PROBE_SYMBOLS = {dt: f"{PROBE}_{s}" for dt, s in _DTYPES.items()}
_PROBE_OCC_SYMBOLS = {dt: f"{PROBE}_occupancy_{s}" for dt, s in _DTYPES.items()}
_PROBE_SIGNATURES = {**{s: _PROBE_ARGS for s in _PROBE_SYMBOLS.values()},
                     **{s: _PROBE_OCC_ARGS for s in _PROBE_OCC_SYMBOLS.values()}}
_SCATTER_SYMBOLS = {
    (vt, rt): f"{SCATTER}_{vs}_{rs}"
    for vt, vs in _DTYPES.items() for rt, rs in _DTYPES.items()
}

# Kernel launches since the last reset, by kernel (chip_smoke.py reads them).
launches = {PROBE: 0, SCATTER: 0}

# K4's winner scratch: one [C] 32-bit word per slot and (device, stream, C),
# never cleared between calls: each call's words lie above every earlier
# call's (csrc/scatter_update.cu).
MAX_WORD = 2**32 - 1
_winners: dict[tuple, list] = {}  # key -> [scratch, the next call's base]
_winners_lock = threading.Lock()  # two threads may share a stream


def probe_gather_pool_work(values: torch.Tensor, n_slots: int, num_bags: int) -> work.Work:
    """K3's work: the ids and weights, one key and one cached row a slot,
    the [bags, D] f32 sums and the [N] miss mask written, a multiply and an
    add a slot's element.  By the shapes: a slot that probes further reads
    more keys, a miss or a zero-weight slot no row."""
    D = values.shape[1]
    return work.Work(bytes=n_slots * (13 + D * values.element_size()) + num_bags * D * 4,
                     f32=2.0 * n_slots * D)


def scatter_update_work(values: torch.Tensor, rows: torch.Tensor) -> work.Work:
    """K4's work: the slots and rows read once, each row written into the
    cache once (a repeated slot's losers too: the shapes do not say which
    win); no products."""
    K, D = rows.shape
    return work.Work(bytes=K * (4 + D * (rows.element_size() + values.element_size())))


def _check_same_device(name: str, ref_t: torch.Tensor, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != ref_t.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on {ref_t.device}")


def probe_gather_pool(
    keys: torch.Tensor,  # [C] int32 slot keys (EMPTY_KEY = vacant), C = 2^n
    values: torch.Tensor,  # [C, D] f32 | bf16 cached rows
    ids: torch.Tensor,  # [N] int32 lookup ids, N = num_bags * nnz
    weights: torch.Tensor,  # [N] f32 (0.0 masks a slot; 1/count for mean)
    num_bags: int,
    max_probes: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused probe + gather + pool: (pooled [num_bags, D] f32, miss [N] bool)."""
    same_device_type(keys, values, ids, weights)
    if not _is_cuda(values):
        return ref.probe_gather_pool_ref(keys, values, ids, weights, num_bags,
                                         max_probes)
    if values.dtype not in _PROBE_SYMBOLS:
        raise TypeError(f"{PROBE}: values dtype {values.dtype} not in f32/bf16")
    if keys.dim() != 1 or values.dim() != 2 or keys.shape[0] != values.shape[0]:
        raise ValueError(f"{PROBE}: want keys [C], values [C, D]; got "
                         f"{tuple(keys.shape)}, {tuple(values.shape)}")
    if ids.dim() != 1 or weights.shape != ids.shape:
        raise ValueError(f"{PROBE}: want ids [N], weights [N]; got "
                         f"{tuple(ids.shape)}, {tuple(weights.shape)}")
    if keys.dtype != torch.int32 or ids.dtype != torch.int32 or \
            weights.dtype != torch.float32:
        raise TypeError(f"{PROBE}: keys and ids must be int32, weights f32")
    _check_same_device(PROBE, values, keys=keys, values=values, ids=ids,
                       weights=weights)
    C, D = values.shape
    N = ids.shape[0]
    if C & (C - 1) or C == 0:
        raise ValueError(f"{PROBE}: num_slots must be a power of two, got {C}")
    if num_bags <= 0 or N % num_bags or max_probes < 1:
        raise ValueError(f"{PROBE}: fixed-nnz layout and max_probes >= 1 "
                         f"required (N={N}, bags={num_bags}, P={max_probes})")
    if C > 2**31:
        raise ValueError(f"{PROBE}: at most 2^31 slots, got {C}")
    pooled = torch.empty((num_bags, D), dtype=torch.float32, device=values.device)
    miss = torch.empty((N,), dtype=torch.bool, device=values.device)
    work.kernel((PROBE,), probe_gather_pool_work, values, N, num_bags)
    if work.on_meta(values):
        return pooled, miss
    shift = max(1, 33 - C.bit_length())
    lib = build.load(PROBE, _PROBE_SIGNATURES)
    vec = vec_width(values.dtype, D, (values.data_ptr() | pooled.data_ptr()) % 16 == 0)
    with torch.cuda.device(values.device):
        plan = launch_plan(num_bags, N // num_bags, D, vec, lambda spec: resident_blocks(
            lib, PROBE, _PROBE_OCC_SYMBOLS[values.dtype], values.device, vec, spec),
            PASS_FLOATS)
        code = getattr(lib, _PROBE_SYMBOLS[values.dtype])(
            keys.data_ptr(), values.data_ptr(), ids.data_ptr(),
            weights.data_ptr(), pooled.data_ptr(), miss.data_ptr(),
            num_bags, N // num_bags, D, C, shift, max_probes, plan.vec,
            plan.lanes, plan.nnz_spec, plan.pass_bags, plan.blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, PROBE, code)
    launches[PROBE] += 1
    return pooled, miss


def winner_scratch(device: torch.device, stream: int, num_slots: int,
                   writes: int) -> tuple[torch.Tensor, int]:
    """(scratch, base) for one K4 call of ``writes`` writes on ``stream``:
    the int32 scratch of (device, stream, num_slots), made as zeros at first
    use, and the base of this call's words base .. base + writes - 1, which
    starts at 1 and rises by the writes of every call.  Where the words
    would pass ``MAX_WORD`` (as unsigned 32-bit), the scratch is zeroed (on
    the current stream, before the launch) and base starts again at 1."""
    key = (device, stream, num_slots)
    with _winners_lock:
        entry = _winners.get(key)
        if entry is None:
            entry = _winners[key] = [torch.zeros((num_slots,), dtype=torch.int32,
                                                 device=device), 1]
        if entry[1] + writes - 1 > MAX_WORD:
            entry[0].zero_()
            entry[1] = 1
        base = entry[1]
        entry[1] += writes
        return entry[0], base


def scatter_update(
    values: torch.Tensor,  # [C, D] f32 | bf16 cache rows, updated in place
    slots: torch.Tensor,  # [K] int32 target slots (duplicates: last write wins)
    rows: torch.Tensor,  # [K, D] f32 | bf16 admitted rows
) -> torch.Tensor:
    """Swap-in: write rows[i] (cast to values' dtype) into values[slots[i]]
    in place and return ``values``, as the reference's aliased output does."""
    same_device_type(values, slots, rows)
    if not _is_cuda(values):
        return ref.scatter_update_ref(values, slots, rows)
    key = (values.dtype, rows.dtype)
    if key not in _SCATTER_SYMBOLS:
        raise TypeError(f"{SCATTER}: values/rows dtypes {key} not in f32/bf16")
    if values.dim() != 2 or slots.dim() != 1 or rows.dim() != 2 or \
            rows.shape != (slots.shape[0], values.shape[1]):
        raise ValueError(f"{SCATTER}: want values [C, D], slots [K], rows [K, D]; "
                         f"got {tuple(values.shape)}, {tuple(slots.shape)}, "
                         f"{tuple(rows.shape)}")
    if slots.dtype != torch.int32:
        raise TypeError(f"{SCATTER}: slots must be int32")
    _check_same_device(SCATTER, values, values=values, slots=slots, rows=rows)
    K = slots.shape[0]
    if K == 0:
        return values
    if K >= 2**31:
        raise ValueError(f"{SCATTER}: at most 2^31 - 1 writes per launch, got {K}")
    C, D = values.shape
    work.kernel((SCATTER,), scatter_update_work, values, rows)
    if work.on_meta(values):
        return values
    lib = build.load(SCATTER, {s: _SCATTER_ARGS for s in _SCATTER_SYMBOLS.values()})
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        winner, base = winner_scratch(values.device, stream, C, K)
        code = getattr(lib, _SCATTER_SYMBOLS[key])(
            values.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            winner.data_ptr(), K, C, D, base, stream,
        )
    build.check(lib, SCATTER, code)
    launches[SCATTER] += 1
    return values
