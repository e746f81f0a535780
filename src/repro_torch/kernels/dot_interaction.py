"""Kernel K2: DLRM dot interaction (batched gram matrix), CUDA for Hopper.

Port of ``repro/kernels/dot_interaction.py::dot_interaction``; the source and
its design note are ``csrc/dot_interaction.cu``.  ``dot_interaction``
launches the kernel on CUDA tensors only; ``ops.dot_interaction_triu`` routes
a CPU tensor to the plain version (``ref.dot_interaction_ref``).  Unlike the
TPU kernel it takes any batch size: there is no ``block_b``.

``dot_interaction_backward`` is kernel K2' (same source): the gradient of the
gram matrix's upper triangle, ``dx = (G + G^T) x``, a block a sample and a
block of rows (``backward_plan``, the host's launch plan);
``ops.dot_interaction_triu`` wires K2 and K2' into autograd for CUDA tensors.
On the ``meta`` device (the dry run) both wrappers check and allocate as on
the card, then report ``dot_interaction_work`` /
``dot_interaction_backward_work`` to ``kernels.work`` and launch nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, work

NAME = "dot_interaction"
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]
_SYMBOLS = {torch.float32: "dot_interaction_f32",
            torch.bfloat16: "dot_interaction_bf16"}

MAX_SMEM = 232448  # bytes of shared memory one block can hold (227 KB)

BWD_SYMBOL = "dot_interaction_backward_f32"
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]
BWD_THREADS = 64  # threads a K2' block (at most kBwdMaxThreads = 128)
BWD_ROWS_PER_THREAD = 2  # rows i a thread sums (1-4: the source's instantiations)
_SIGNATURES = {**{sym: _ARGS for sym in _SYMBOLS.values()}, BWD_SYMBOL: _BWD_ARGS}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_backward = 0  # K2' launches


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def dot_interaction_work(x: torch.Tensor) -> work.Work:
    """K2's work: x [B, F, D] read once, the [B, F, F] f32 gram written
    once, 2 F^2 D FMA operations a sample (the whole square, as the
    kernel's output; f32 FMAs in both dtypes)."""
    B, F, D = x.shape
    return work.Work(bytes=x.numel() * x.element_size() + B * F * F * 4,
                     f32=2.0 * B * F * F * D)


def dot_interaction_backward_work(x: torch.Tensor, grad_tri: torch.Tensor) -> work.Work:
    """K2''s work: x and the triangle's gradient read once, dx written once,
    the product (G + G^T) x: 2 F^2 D FMA operations a sample."""
    B, F, D = x.shape
    return work.Work(bytes=(2 * x.numel() + grad_tri.numel()) * 4, f32=2.0 * B * F * F * D)


def sample_smem_bytes(F: int, D: int, itemsize: int) -> int:
    """Shared memory the kernel needs for one sample: two buffers of F rows
    padded to a multiple of 4, each row an odd number of 16-byte vectors,
    plus the sample's [F, F] f32 result (``make_plan`` in the source at
    G = 1)."""
    units = D * itemsize // 16
    return 2 * (-(-F // 4) * 4) * (units | 1) * 16 + F * F * 4


def check_inputs(x: torch.Tensor) -> None:
    """Raise on what the kernel does not take: a dtype other than f32/bf16,
    a shape other than a contiguous [B, F, D], rows that are not a multiple
    of 16 bytes or a start off a 16-byte boundary (its loads are 16-byte
    vectors), or one sample too large for a block's shared memory."""
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"{NAME}: dtype {x.dtype} not in f32/bf16")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{NAME}: want a contiguous [B, F, D], got {tuple(x.shape)}")
    _, F, D = x.shape
    if (D * x.element_size()) % 16:
        raise ValueError(f"{NAME}: rows of D={D} {x.dtype} are not a multiple of 16 bytes")
    if x.data_ptr() % 16:
        raise ValueError(f"{NAME}: x must start on a 16-byte boundary")
    if sample_smem_bytes(F, D, x.element_size()) > MAX_SMEM:
        raise ValueError(f"{NAME}: one [F={F}, D={D}] sample needs "
                         f"{sample_smem_bytes(F, D, x.element_size())} bytes of shared "
                         f"memory, over the {MAX_SMEM} a block holds")


def dot_interaction(x: torch.Tensor) -> torch.Tensor:
    """``[B, F, D]`` f32 | bf16 CUDA tensor -> ``[B, F, F]`` f32, kernel K2."""
    global launches
    check_inputs(x)
    if not (_on_cuda(x) or work.on_meta(x)):
        raise ValueError(
            f"{NAME} kernel takes CUDA tensors, got {x.device}; "
            "ops.dot_interaction_triu routes CPU tensors to the plain version"
        )
    B, F, D = x.shape
    out = torch.empty((B, F, F), dtype=torch.float32, device=x.device)
    work.kernel((NAME,), dot_interaction_work, x)
    if work.on_meta(x):
        return out
    lib = build.load(NAME, _SIGNATURES)
    with torch.cuda.device(x.device):
        code = getattr(lib, _SYMBOLS[x.dtype])(
            x.data_ptr(), out.data_ptr(), B, F, D,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, NAME, code)
    launches += 1
    return out


def backward_smem_bytes(F: int, D: int) -> int:
    """Shared memory a K2' block needs: the sample's rows [F, D] and its
    triangle's gradient [F(F+1)/2], f32 (``backward_smem`` in the source)."""
    return (F * D + F * (F + 1) // 2) * 4


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    vec: int  # f32 a thread loads and stores at once: 4 (16 bytes) or 1
    col_threads: int  # threads across a row's vectors: a power of two, <= 32
    row_threads: int  # threads down the rows; a block is col_threads x row_threads
    rows_per_thread: int  # rows i a thread sums, row_threads apart
    row_blocks: int  # blocks a sample: each takes row_threads x rows_per_thread rows


def backward_plan(F: int, D: int, aligned: bool) -> BackwardPlan:
    """K2''s launch: ``BWD_THREADS`` threads a block, ``col_threads`` of them
    across a row's 16-byte vectors (4-byte where D or the pointers are not
    16-byte multiples; a power of two up to 32, looping over wider rows),
    the rest down the rows, ``BWD_ROWS_PER_THREAD`` rows each; a sample takes
    as many blocks as its F rows need."""
    vec = 4 if aligned and D % 4 == 0 else 1
    cols = 1
    while cols < min(D // vec, 32):
        cols *= 2
    rows = max(1, BWD_THREADS // cols)
    per = BWD_ROWS_PER_THREAD
    return BackwardPlan(vec, cols, rows, per, -(-F // (rows * per)))


def dot_interaction_backward(x: torch.Tensor, grad_tri: torch.Tensor) -> torch.Tensor:
    """``[B, F, D]`` f32 gradient of ``x`` from the gradient of its gram
    matrix's upper triangle ``grad_tri`` ``[B, F(F+1)/2]`` f32 (the order of
    ``np.triu_indices(F)``), kernel K2'."""
    global launches_backward
    if x.dtype != torch.float32 or grad_tri.dtype != torch.float32:
        raise TypeError(f"{NAME}_backward: x and grad_tri must be f32, got "
                        f"{x.dtype} and {grad_tri.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{NAME}_backward: want a contiguous [B, F, D], got {tuple(x.shape)}")
    B, F, D = x.shape
    if grad_tri.shape != (B, F * (F + 1) // 2) or not grad_tri.is_contiguous() \
            or grad_tri.device != x.device:
        raise ValueError(f"{NAME}_backward: want a contiguous [{B}, {F * (F + 1) // 2}] "
                         f"grad_tri on {x.device}, got {tuple(grad_tri.shape)}")
    if backward_smem_bytes(F, D) > MAX_SMEM:
        raise ValueError(f"{NAME}_backward: one [F={F}, D={D}] sample needs "
                         f"{backward_smem_bytes(F, D)} bytes of shared memory, over the "
                         f"{MAX_SMEM} a block holds")
    if not (_on_cuda(x) or work.on_meta(x)):
        raise ValueError(
            f"{NAME}_backward kernel takes CUDA tensors, got {x.device}; "
            "on the CPU autograd differentiates the plain version"
        )
    dx = torch.empty_like(x)
    bwd = f"{NAME}_backward"
    work.kernel((bwd,), dot_interaction_backward_work, x, grad_tri)
    if work.on_meta(x):
        return dx
    lib = build.load(NAME, _SIGNATURES)
    plan = backward_plan(F, D, (x.data_ptr() | dx.data_ptr()) % 16 == 0)
    with torch.cuda.device(x.device):
        code = getattr(lib, BWD_SYMBOL)(
            x.data_ptr(), grad_tri.data_ptr(), dx.data_ptr(), B, F, D, plan.vec,
            plan.rows_per_thread, plan.col_threads, plan.row_threads, plan.row_blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, NAME, code)
    launches_backward += 1
    return dx
