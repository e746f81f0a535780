"""Kernel K7: flash decoding (one query token against a KV cache), CUDA for
Hopper.

Port of ``repro/kernels/flash_decode.py::flash_decode``; the source and its
design note are ``csrc/flash_decode.cu``.  ``flash_decode`` launches the
kernel on CUDA tensors only; ``ops.flash_decode`` routes a CPU tensor to the
plain version (``ref.flash_decode_ref``).  The valid length is a device
int32 tensor that the kernel reads itself (the TPU kernel's scalar
prefetch), so a decode loop never waits on the host.  Unlike the TPU kernel
it takes any S (no ``block_k``); head dims ``HEAD_DIMS[dtype]`` only.

``flash_decode_partial`` runs the same kernel in its shard mode, for the
sequence-sharded decode: the caches are one shard of the positions, whose
start is a second device int32 tensor, and the kernel returns the shard's
un-normalised f32 sum with each row's max and sum of exponentials, for the
combine across shards (``models.layers.flash_decode_shard``).

The kernel splits the positions into chunks (``plan_split``, from the shapes
alone, so the host never reads ``cache_len``); each block writes a partial
(m, l, acc) to an f32 workspace and the last block of each group combines
them, counted by int32 tickets that the kernel leaves at zero.  Workspace
and tickets stay allocated per (device, stream), so a call allocates only
its output: calls on one stream run in order, and none reads another's
workspace.  On the ``meta`` device (the dry run) the wrappers check and
allocate their outputs as on the card, then report ``flash_decode_work``
to ``kernels.work`` and launch nothing (no workspace).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build, work

NAME = "flash_decode"
# The kernel's instantiations, by dtype: the same in both (16 and 32 are
# lm-small's and the registry's smoke configs', whose decode steps run on
# the card in either compute dtype).
HEAD_DIMS = {torch.float32: (16, 32, 64, 80, 96, 128),
             torch.bfloat16: (16, 32, 64, 80, 96, 128)}
_ARGS = [ctypes.c_void_p] * 9 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_SYMBOLS = {torch.float32: "flash_decode_f32", torch.bfloat16: "flash_decode_bf16"}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_partial = 0  # of those, launches in the shard mode

# The split over positions (the kernel's kGroupHeads is GROUP_HEADS).
SMS = 132  # an H100's streaming multiprocessors
TARGET_BLOCKS = 4 * SMS  # at least four blocks an SM, where S allows
MIN_CHUNK = 128  # positions: no chunk shorter, unless S is
MAX_CHUNK = 1024  # positions: longer caches take more chunks
MAX_SPLIT = 512  # chunks at most (kMaxSplit: the combine's shared memory)
MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z = chunks x head chunks
GROUP_HEADS = 4  # the kernel's kGroupHeads: query heads a block when g > 1

# (device, stream) -> (f32 workspace, int32 tickets, zeros between launches)
_scratch: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
_scratch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def plan_split(S: int, B: int, Hkv: int, group: int) -> int:
    """The number of chunks the kernel splits S positions into, for B
    batches of Hkv KV heads of ``group`` query heads each: enough that the
    grid reaches ``TARGET_BLOCKS`` blocks and no chunk passes ``MAX_CHUNK``,
    as far as chunks of at least ``MIN_CHUNK``, ``MAX_SPLIT`` and the grid's
    limit allow."""
    head_chunks = 1 if group == 1 else -(-group // GROUP_HEADS)
    want = max(-(-TARGET_BLOCKS // (B * Hkv * head_chunks)), -(-S // MAX_CHUNK))
    return max(1, min(want, S // MIN_CHUNK, MAX_SPLIT, MAX_GRID_Z // head_chunks))


def chunk_bounds(S: int, n_split: int) -> list[int]:
    """Where the kernel's chunks start, and S: chunk i is
    [i S // n_split, (i + 1) S // n_split)."""
    return [i * S // n_split for i in range(n_split + 1)]


def flash_decode_work(q: torch.Tensor, k_cache: torch.Tensor, partial: bool) -> work.Work:
    """K7's work: q read and the output written once (in shard mode the f32
    sum and the [B, H, 2] f32 max and sum), both caches read once, two
    products of 2 dh f32 FMA operations a position and query head.  An
    upper bound: the whole cache, where the kernel reads only the positions
    below ``cache_len``, a device value."""
    B, H, dh = q.shape
    out = B * H * (dh + 2) * 4 if partial else q.numel() * q.element_size()
    return work.Work(bytes=q.numel() * q.element_size() + out
                     + 2 * k_cache.numel() * k_cache.element_size(),
                     f32=4.0 * B * H * k_cache.shape[1] * dh)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _scratch_for(device: torch.device, stream: int, ws_elems: int,
                 n_tickets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The workspace (at least ``ws_elems`` f32) and tickets (at least
    ``n_tickets`` int32 zeros) kept for (device, stream), each made or grown
    (to twice its size at least) when a launch needs more.  The kernel
    leaves the tickets at zero, so they are zeroed only when made."""
    key = (device, stream)
    with _scratch_lock:
        ws, tickets = _scratch.get(key, (None, None))
        if ws is None or ws.numel() < ws_elems:
            ws = torch.empty((max(ws_elems, 2 * (0 if ws is None else ws.numel())),),
                             dtype=torch.float32, device=device)
        if tickets is None or tickets.numel() < n_tickets:
            tickets = torch.zeros((max(n_tickets, 2 * (0 if tickets is None
                                                       else tickets.numel())),),
                                  dtype=torch.int32, device=device)
        _scratch[key] = ws, tickets
        return ws, tickets


def check_inputs(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len: torch.Tensor, shard_start: torch.Tensor | None = None) -> None:
    """Raise on what the kernel does not take: a dtype other than f32/bf16
    or mixed dtypes, shapes other than q [B,H,dh], caches [B,S,Hkv,dh] with
    Hkv dividing H, a head dim outside ``HEAD_DIMS``, non-contiguous
    tensors, or a ``cache_len`` (or ``shard_start``) that is not one int32
    element."""
    if q.dtype not in _SYMBOLS or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{NAME}: dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}; "
                        "want one of f32 / bf16 for q and both caches")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{NAME}: want q [B,H,dh] and caches [B,S,Hkv,dh], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, dh = q.shape
    if (k_cache.shape[0], k_cache.shape[3]) != (B, dh) or H % k_cache.shape[2]:
        raise ValueError(f"{NAME}: caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B, dh; Hkv divides H)")
    if dh not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"{NAME}: head dim {dh} not in {HEAD_DIMS[q.dtype]} for "
                         f"{str(q.dtype)[6:]}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{NAME}: q and the caches must be contiguous")
    for name, t in (("cache_len", cache_len), ("shard_start", shard_start)):
        if t is not None and (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                              or t.numel() != 1):
            raise TypeError(f"{NAME}: {name} must be an int32 tensor of one element")


def _launch(q, k_cache, v_cache, cache_len, shard_start, out, ml) -> None:
    """One launch of the kernel, in shard mode when ``shard_start`` is given."""
    global launches, launches_partial
    devs = {t.device for t in (q, k_cache, v_cache, cache_len, shard_start) if t is not None}
    if not (_on_cuda(q) or work.on_meta(q)) or len(devs) != 1:
        raise ValueError(
            f"{NAME} kernel takes CUDA tensors on one device, got {sorted(map(str, devs))}; "
            "ops.flash_decode routes CPU tensors to the plain version"
        )
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"{NAME}: q and the caches must start on 16-byte boundaries")
    B, H, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    names = (NAME, f"{NAME}_partial") if shard_start is not None else (NAME,)
    work.kernel(names, flash_decode_work, q, k_cache, shard_start is not None)
    if work.on_meta(q):
        return
    n_split = plan_split(S, B, Hkv, H // Hkv)
    lib = build.load(NAME, {sym: _ARGS for sym in _SYMBOLS.values()})
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = tickets = 0
        if n_split > 1:
            ws, tickets = (t.data_ptr() for t in _scratch_for(
                q.device, stream, B * H * n_split * (dh + 2), B * H))
        code = getattr(lib, _SYMBOLS[q.dtype])(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
            None if shard_start is None else shard_start.data_ptr(), out.data_ptr(),
            None if ml is None else ml.data_ptr(), ws, tickets, B, S, H, Hkv, dh, n_split,
            stream,
        )
    build.check(lib, NAME, code)
    launches += 1
    launches_partial += shard_start is not None


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len: torch.Tensor) -> torch.Tensor:
    """q [B,H,dh], caches [B,S,Hkv,dh] (f32 | bf16), ``cache_len`` an int32
    CUDA tensor of one element -> [B,H,dh] in q's dtype: each query head
    attends to positions ``< cache_len`` of its KV head; nothing at or past
    ``cache_len`` is read."""
    check_inputs(q, k_cache, v_cache, cache_len)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k_cache, v_cache, cache_len, None, out, None)
    return out


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         cache_len: torch.Tensor, shard_start: torch.Tensor):
    """The kernel's shard mode: the caches [B,S,Hkv,dh] hold positions
    ``shard_start ..`` of a longer cache (``shard_start`` an int32 CUDA
    tensor of one element), of which those ``< cache_len`` are valid.
    Returns ``(acc [B,H,dh] f32, m [B,H] f32, l [B,H] f32)``: the sum of
    ``round(exp(s - m)) v`` over the valid positions, not divided by ``l``,
    the row max ``m`` of the scaled scores and ``l``, the sum of
    ``exp(s - m)``; a shard with no valid position gives ``m = -inf``,
    ``l = 0``, ``acc = 0``.  Nothing at or past ``cache_len`` is read."""
    check_inputs(q, k_cache, v_cache, cache_len, shard_start)
    B, H, dh = q.shape
    out = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    ml = torch.empty((B, H, 2), dtype=torch.float32, device=q.device)
    _launch(q, k_cache, v_cache, cache_len, shard_start, out, ml)
    return out, ml[..., 0], ml[..., 1]
