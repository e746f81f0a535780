"""Kernel K5: the co-occurrence prefetcher's top-k neighbor select.

Port of ``repro/prefetch/kernels.py::topk_neighbor_select``; the CUDA source
and its design note are ``csrc/topk_neighbor_select.cu``.  The entry point
dispatches by the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version (``prefetch/ref.py``), a
``meta`` tensor (the dry run) reports ``topk_neighbor_select_work`` to
``kernels.work`` after the card's checks and launches nothing.  Unlike
the TPU kernel it takes f64 as well as f32 and does not pad L.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.ops import _is_cuda
from repro_torch.prefetch import ref

NAME = "topk_neighbor_select"
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
_SYMBOLS = {torch.float32: f"{NAME}_f32", torch.float64: f"{NAME}_f64"}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def topk_neighbor_select_work(scores: torch.Tensor, k: int) -> work.Work:
    """K5's work: the [M, L] scores read once, k values and int32 indices a
    row written once; comparisons only, no products."""
    M, _ = scores.shape
    return work.Work(bytes=scores.numel() * scores.element_size()
                     + M * k * (scores.element_size() + 4))


def topk_neighbor_select(
    scores: torch.Tensor,  # [M, L] f32 | f64 candidate scores (-inf = absent)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k, ties to the lowest column: (values [M, k] in the
    scores' dtype, indices [M, k] int32)."""
    global launches
    if not _is_cuda(scores):
        return ref.topk_neighbor_select_ref(scores, k)
    if scores.dtype not in _SYMBOLS:
        raise TypeError(f"{NAME}: scores dtype {scores.dtype} not in f32/f64")
    if scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError(f"{NAME}: want contiguous scores [M, L], got "
                         f"{tuple(scores.shape)}")
    M, L = scores.shape
    if k > L:
        raise ValueError(f"k={k} exceeds candidate width {L}")
    vals = torch.empty((M, k), dtype=scores.dtype, device=scores.device)
    idx = torch.empty((M, k), dtype=torch.int32, device=scores.device)
    if M == 0 or k <= 0:
        return vals, idx
    work.kernel((NAME,), topk_neighbor_select_work, scores, k)
    if work.on_meta(scores):
        return vals, idx
    lib = build.load(NAME, {s: _ARGS for s in _SYMBOLS.values()})
    with torch.cuda.device(scores.device):
        code = getattr(lib, _SYMBOLS[scores.dtype])(
            scores.data_ptr(), vals.data_ptr(), idx.data_ptr(), M, L, k,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, NAME, code)
    launches += 1
    return vals, idx
