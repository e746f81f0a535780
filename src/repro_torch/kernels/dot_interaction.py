"""Kernel K2: DLRM dot interaction (batched gram matrix), CUDA for Hopper.

Port of ``repro/kernels/dot_interaction.py::dot_interaction``; the source and
its design note are ``csrc/dot_interaction.cu``.  ``dot_interaction``
launches the kernel on CUDA tensors only; ``ops.dot_interaction_triu`` routes
a CPU tensor to the plain version (``ref.dot_interaction_ref``).  Unlike the
TPU kernel it takes any batch size: there is no ``block_b``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "dot_interaction"
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]
_SYMBOLS = {torch.float32: "dot_interaction_f32",
            torch.bfloat16: "dot_interaction_bf16"}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)


def dot_interaction(x: torch.Tensor) -> torch.Tensor:
    """``[B, F, D]`` f32 | bf16 CUDA tensor -> ``[B, F, F]`` f32, kernel K2."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(
            f"{NAME} kernel takes CUDA tensors, got {x.device}; "
            "ops.dot_interaction_triu routes CPU tensors to the plain version"
        )
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"{NAME}: dtype {x.dtype} not in f32/bf16")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{NAME}: want a contiguous [B, F, D], got {tuple(x.shape)}")
    B, F, D = x.shape
    out = torch.empty((B, F, F), dtype=torch.float32, device=x.device)
    lib = build.load(NAME, {sym: _ARGS for sym in _SYMBOLS.values()})
    with torch.cuda.device(x.device):
        code = getattr(lib, _SYMBOLS[x.dtype])(
            x.data_ptr(), out.data_ptr(), B, F, D,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, NAME, code)
    launches += 1
    return out
