"""Kernel K6: causal or full GQA flash attention (forward), CUDA for Hopper.

Port of ``repro/kernels/flash_attention.py::flash_attention``; the source and
its design note are ``csrc/flash_attention.cu``.  ``flash_attention``
launches the kernel on CUDA tensors only; ``ops.flash_attention`` routes a
CPU tensor to the plain version (``ref.flash_attention_ref``).  Unlike the
TPU kernel it takes any S (no ``block_q``/``block_k``), reads the
``[B, S, H, dh]`` layout through strides, and takes head dims
``HEAD_DIMS`` only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
HEAD_DIMS = (64, 80, 96, 128)  # the kernel's instantiations (multiples of 16)
MAX_SEQ = 2**31 - 256  # the kernels' positions (and the bf16 TMA coordinates) are int32
_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
]
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_f32 = 0  # of those, launches of the f32 kernel


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take: a dtype other than f32/bf16
    or mixed dtypes, shapes other than q [B,S,H,dh], k = v [B,S,Hkv,dh] with
    Hkv dividing H, a head dim outside ``HEAD_DIMS``, a last dim that is not
    contiguous, rows not on 16-byte boundaries: a start or a stride that is
    no multiple of 16 bytes (the bf16 kernel loads its tiles with TMA, the
    f32 kernel with 16-byte copies; both require both), or an S past
    ``MAX_SEQ``."""
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{NAME}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        "want one of f32 / bf16 for q, k and v")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME}: want q [B,S,H,dh] and k, v [B,S,Hkv,dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, dh) or H % k.shape[2]:
        raise ValueError(f"{NAME}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B, S, dh; Hkv divides H)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {dh} not in {HEAD_DIMS}")
    if S > MAX_SEQ:
        raise ValueError(f"{NAME}: S = {S} past the kernel's {MAX_SEQ} positions")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"{NAME}: {name} strides {t.stride()} — want a contiguous "
                             "head dim and rows on 16-byte boundaries")
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} must start on a 16-byte boundary")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,H,dh], k/v [B,S,Hkv,dh], f32 | bf16 CUDA tensors -> [B,S,H,dh]
    in q's dtype: softmax(q k^T / sqrt(dh)) v per head, query head h reading
    KV head h // (H // Hkv), keys after the query masked when ``causal``."""
    global launches, launches_f32
    check_inputs(q, k, v)
    if not _on_cuda(q) or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"{NAME} kernel takes CUDA tensors, got {q.device}, {k.device}, {v.device}; "
            "ops.flash_attention routes CPU tensors to the plain version"
        )
    B, S, H, dh = q.shape
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = build.load(NAME, {sym: _ARGS for sym in _SYMBOLS.values()})
    with torch.cuda.device(q.device):
        code = getattr(lib, _SYMBOLS[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], dh, int(causal), strides,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, NAME, code)
    launches += 1
    launches_f32 += q.dtype == torch.float32
    return out
