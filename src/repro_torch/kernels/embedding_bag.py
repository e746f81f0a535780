"""Kernel K1: fused embedding bag (gather + weighted pool), CUDA for Hopper.

Port of ``repro/kernels/embedding_bag.py::embedding_bag``; the source and its
design note are ``csrc/embedding_bag.cu``.  ``embedding_bag`` launches the
kernel on CUDA tensors only; ``ops.embedding_bag`` routes a CPU tensor to the
plain version (``ref.embedding_bag_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "embedding_bag"
_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p,
]
_SYMBOLS = {torch.float32: "embedding_bag_f32", torch.bfloat16: "embedding_bag_bf16"}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def embedding_bag(
    table: torch.Tensor,  # [V, D] f32 | bf16, CUDA, contiguous
    indices: torch.Tensor,  # [N] int32, N = num_bags * nnz
    weights: torch.Tensor,  # [N] f32
    num_bags: int,
) -> torch.Tensor:
    """``[num_bags, D]`` f32 weighted bag sums, computed by kernel K1."""
    global launches
    if table.device.type != "cuda":
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
    out = torch.empty((num_bags, D), dtype=torch.float32, device=table.device)
    lib = build.load(NAME, {sym: _ARGS for sym in _SYMBOLS.values()})
    with torch.cuda.device(table.device):
        code = getattr(lib, _SYMBOLS[table.dtype])(
            table.data_ptr(), indices.data_ptr(), weights.data_ptr(),
            out.data_ptr(), num_bags, N // num_bags, D, V,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, NAME, code)
    launches += 1
    return out
