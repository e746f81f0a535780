"""Kernel K1: fused embedding bag (gather + weighted pool), CUDA for Hopper.

Port of ``repro/kernels/embedding_bag.py::embedding_bag``; the source and its
design note are ``csrc/embedding_bag.cu``.  ``embedding_bag`` launches the
kernel on CUDA tensors only; ``ops.embedding_bag`` routes a CPU tensor to the
plain version (``ref.embedding_bag_ref``).  Two modes, one source: weighted
(every row times its weight, the Pallas kernel's contract) and ``masked``
(zero-weight slots skipped, their rows never loaded).  ``launch_plan`` is
the launch geometry, computed here on the host.

``embedding_bag_backward`` is kernel K1', the table's gradient (same source):
one cooperative launch that writes every row of the dense gradient once,
zeros where no live slot names the row and elsewhere the row's slots summed
in slot order, so the gradient is the same bit for bit on every run.  It
groups the slots by row itself (a bitmap of the rows, each touched row's
rank among them, a slot list, and buckets that order the long runs, kept
per (device, stream) in ``_bwd_scratch``); ``backward_scratch_sizes``,
``backward_long_cap``, ``backward_bucket_bits``, ``backward_bucket_cap``,
``backward_blocks`` and ``BackwardState`` are its host-side plan.
``ops.embedding_bag`` wires both into autograd for CUDA tables.  On the
``meta`` device (the dry run) both wrappers check and allocate as on the
card, then report ``embedding_bag_work`` / ``embedding_bag_backward_work``
to ``kernels.work`` in place of the launch: no library, no scratch, no
``BackwardState`` step, no count.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Callable

import torch

from repro_torch.kernels import build, work

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
BWD_SYMBOL = f"{NAME}_backward_f32"  # K1'
BWD_OCC_SYMBOL = f"{NAME}_backward_occupancy"
_SIGNATURES = {
    **{s: _ARGS for s in _SYMBOLS.values()},
    **{s: _OCC_ARGS for s in _OCC_SYMBOLS.values()},
    BWD_SYMBOL: [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 13 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p],
    BWD_OCC_SYMBOL: [ctypes.c_int],
}
_WIDE_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
# K1''s launch: one wave of 256-thread blocks (warps 0-1 group, the other
# warps fill, all sum), at most BWD_BLOCKS_PER_SM an SM (2 ran faster than
# 3 or 4: fewer barrier arrivals, the fill's loads ahead of its stores)
BWD_BLOCKS_PER_SM = 2
BWD_GROUP_WARPS = 2  # warps of a block that group the slots (kGroupWarps)
BWD_SORT_CAP = 128  # runs and buckets up to this long are ordered by rank (kSortCap)
BWD_WINDOW = 32 * BWD_SORT_CAP  # a longer bucket: slots a bitmap window spans (kWindow)
BWD_BUCKET_AIM = 32  # a long run's buckets: its length over this, a power of two (kBucketAim)
BWD_TILE = 128  # a long run's slots a warp moves into buckets at a time (kTile)
BWD_HOT_RUN = 4096  # long runs this long are summed first (kHotRun)
BWD_COUNTERS = 20 * 32  # grid-wide counts, one 128-byte line each (kCounters)
MAX_ROWS = 2**31 - 2  # K1' keeps rows and their ranks as 32-bit words
MAX_SLOTS = 2**30  # K1' keeps slots, ranks and run starts as 32-bit words

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_masked = 0  # those of them in the masked mode
launches_backward = 0  # K1' launches

_occupancy: dict[tuple, int] = {}  # blocks an SM holds, by resident_blocks' key
_occupancy_lock = threading.Lock()
# K1''s scratch by (device, stream): {name: tensor}, see backward_scratch_sizes,
# and the next launch's number and bitmap half (BackwardState)
_bwd_scratch: dict[tuple, dict[str, torch.Tensor]] = {}
_bwd_state: dict[tuple, "BackwardState"] = {}
# the last launch's plan by (device, stream): its key (library, vec, slots,
# rows), the scratch it was made from, the grid and the scratch pointers,
# kept while both hold, so a step that repeats a launch computes none of it
# again
_bwd_plan: dict[tuple, tuple] = {}
_bwd_scratch_lock = threading.Lock()
# the parts made as zeros: K1' leaves the counters, the chunks' marks, the
# counts and the buckets at zero, clears each bitmap half the launch after
# it marks it, and releases a phase by writing its launch number (never 0)
# into the flags
BWD_ZEROED = ("counters", "flags", "bitmap", "wchunk", "counts", "buckets")
# the parts after the bitmap's halves, in the order the library takes them
BWD_POINTERS = ("wchunk", "wprefix", "counts", "ebase", "runs", "rowof", "slot_entry",
                "slot_rank", "list", "longs", "buckets", "brun", "order")


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


def embedding_bag_work(table: torch.Tensor, n_slots: int, num_bags: int) -> work.Work:
    """K1's work: the ids and weights, one table row a slot, the [bags, D]
    f32 sums written, a multiply and an add a slot's element.  An upper
    bound: the kernel reads a row once a slot, but the masked mode skips
    a zero-weight slot's row, and the L2 serves a row repeated in a bag."""
    D = table.shape[1]
    return work.Work(bytes=n_slots * (8 + D * table.element_size()) + num_bags * D * 4,
                     f32=2.0 * n_slots * D)


def embedding_bag_backward_work(grad_out: torch.Tensor, n_slots: int,
                                num_rows: int) -> work.Work:
    """K1''s work: the [bags, D] output gradient, the ids and weights read
    once, the dense [num_rows, D] f32 gradient written once (every row),
    a multiply and an add a slot's element."""
    num_bags, D = grad_out.shape
    return work.Work(bytes=(num_bags * D + num_rows * D) * 4 + n_slots * 8,
                     f32=2.0 * n_slots * D)


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
    if not (_on_cuda(table) or work.on_meta(table)):
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
    names = (NAME, f"{NAME}_masked") if masked else (NAME,)
    work.kernel(names, embedding_bag_work, table, N, num_bags)
    if work.on_meta(table):
        return out
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


def backward_long_cap(n_slots: int) -> int:
    """K1''s long runs at most (runs past ``BWD_SORT_CAP`` slots; at least 1)."""
    return max(1, n_slots // (BWD_SORT_CAP + 1))


def backward_bucket_bits(length: int) -> int:
    """log2 of a long run's buckets: its length over ``BWD_BUCKET_AIM``
    rounded up to a power of two (``bucket_bits``)."""
    return (-(-length // BWD_BUCKET_AIM) - 1).bit_length()


def backward_bucket_cap(n_slots: int) -> int:
    """The buckets of every long run together at most: a run of L slots
    has fewer than L / 16 + 2, and there are at most
    ``backward_long_cap`` runs."""
    return n_slots // 16 + 2 * (n_slots // (BWD_SORT_CAP + 1)) + 1


def backward_scratch_sizes(n_slots: int, num_rows: int, blocks: int) -> dict[str, int]:
    """The int32 elements of each part of K1''s scratch for ``n_slots``
    slots into ``num_rows`` rows on a grid of ``blocks`` (each at least 1):
    the grid-wide counters, a 128-byte flag line a block, two halves of a
    bitmap of the rows, the marks in each grouping warp's chunk of words
    (``BWD_GROUP_WARPS`` a block) and the marks below each word; per slot
    (no more rows are touched than slots are live) each touched row's
    count, run start (two words: the start and the long index), run (four
    words) and row, each slot's row's rank and place in its run and the
    slot list; the long
    runs (four words each), their buckets' counts and long indices, and per
    slot the long runs' slots bucket by bucket."""
    n = max(1, n_slots)
    words = -(-num_rows // 32)
    buckets = backward_bucket_cap(n_slots)
    return {"counters": BWD_COUNTERS, "flags": 32 * blocks, "bitmap": 2 * words,
            "wchunk": BWD_GROUP_WARPS * blocks, "wprefix": words, "counts": n, "ebase": 2 * n,
            "runs": 4 * n, "rowof": n, "slot_entry": n, "slot_rank": n, "list": n,
            "longs": 4 * backward_long_cap(n_slots), "buckets": buckets, "brun": buckets,
            "order": n}


def backward_blocks(sms: int, per_sm: int) -> int:
    """K1''s grid: one wave of resident blocks (its cooperative launch takes
    no more), at most ``BWD_BLOCKS_PER_SM`` an SM."""
    return sms * max(1, min(per_sm, BWD_BLOCKS_PER_SM))


@dataclasses.dataclass(frozen=True)
class BackwardState:
    """What one K1' launch on a scratch hands the next.  ``epoch`` is the
    launch's number (never 0), which its barriers write into the flags, so
    no flag is ever reset.  The bitmap is two halves: a launch marks half
    ``parity``, which is all zero, and clears the first
    ``dirty[1 - parity]`` words of the other, the marks of the launch
    before it, so no fill warp waits for every other to be done with a word
    before the word is cleared."""
    epoch: int = 1
    parity: int = 0
    dirty: tuple[int, int] = (0, 0)

    def stale_words(self) -> int:
        return self.dirty[1 - self.parity]

    def after(self, words: int) -> "BackwardState":
        """The state once this launch has marked ``words`` words of its half."""
        dirty = [0, 0]
        dirty[self.parity] = words
        return BackwardState(self.epoch % 0xFFFFFFFF + 1, 1 - self.parity, tuple(dirty))


def backward_scratch(device: torch.device, stream: int, n_slots: int, num_rows: int,
                     blocks: int) -> dict[str, torch.Tensor]:
    """K1''s scratch kept for (device, stream), each part made or grown (to
    twice its size at least) when a launch needs more.  The parts in
    ``BWD_ZEROED`` are zeroed only when made (a new bitmap's halves start
    clean; the launch numbers go on).  Call with ``_bwd_scratch_lock`` held."""
    need = backward_scratch_sizes(n_slots, num_rows, blocks)
    key = (device, stream)
    parts = _bwd_scratch.setdefault(key, {})
    state = _bwd_state.setdefault(key, BackwardState())
    for name, size in need.items():
        have = parts.get(name)
        if have is None or have.numel() < size:
            size = max(size, 2 * (0 if have is None else have.numel()))
            make = torch.zeros if name in BWD_ZEROED else torch.empty
            parts[name] = make((size,), dtype=torch.int32, device=device)
            if name == "bitmap":
                _bwd_state[key] = BackwardState(epoch=state.epoch)
    return dict(parts)


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
    if not (_on_cuda(grad_out) or work.on_meta(grad_out)):
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
    if N > MAX_SLOTS:
        raise ValueError(f"{NAME}_backward: {N} slots over {MAX_SLOTS}")
    grad = torch.empty((num_rows, D), dtype=torch.float32, device=grad_out.device)
    work.kernel((f"{NAME}_backward",), embedding_bag_backward_work, grad_out, N, num_rows)
    if work.on_meta(grad_out):
        return grad
    lib = build.load(NAME, _SIGNATURES)
    vec = vec_width(torch.float32, D, (grad_out.data_ptr() | grad.data_ptr()) % 16 == 0)
    with torch.cuda.device(grad_out.device), _bwd_scratch_lock:
        stream = torch.cuda.current_stream().cuda_stream
        key = (grad_out.device, stream)
        plan = _bwd_plan.get(key)
        if (plan is None or plan[0] != (getattr(lib, "_name", None), vec, N, num_rows)
                or plan[1] is not _bwd_scratch.get(key)):
            sms = sm_count(grad_out.device)
            blocks = backward_blocks(
                sms, resident_blocks(lib, NAME, BWD_OCC_SYMBOL, grad_out.device, vec) // sms)
            sc = backward_scratch(grad_out.device, stream, N, num_rows, blocks)
            plan = ((getattr(lib, "_name", None), vec, N, num_rows), _bwd_scratch[key], blocks,
                    sc["counters"].data_ptr(), sc["flags"].data_ptr(), sc["bitmap"].data_ptr(),
                    4 * (sc["bitmap"].numel() // 2),
                    tuple(sc[k].data_ptr() for k in BWD_POINTERS) + (
                        backward_long_cap(N), backward_bucket_cap(N)))
            _bwd_plan[key] = plan
        _, _, blocks, counters, flags, bitmap, half, rest = plan
        state = _bwd_state[key]
        code = getattr(lib, BWD_SYMBOL)(
            grad_out.data_ptr(), indices.data_ptr(), weights.data_ptr(), grad.data_ptr(),
            N, N // num_bags, D, num_rows, int(masked), vec, blocks, counters, flags,
            state.epoch, bitmap + state.parity * half, bitmap + (1 - state.parity) * half,
            state.stale_words(), *rest, stream)
        build.check(lib, NAME, code)
        _bwd_state[key] = state.after(-(-num_rows // 32))
    launches_backward += 1
    return grad
