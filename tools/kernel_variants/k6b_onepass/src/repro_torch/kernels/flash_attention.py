"""The wrapper module of the one-pass K6' bf16 design that lost in turns
(``../csrc/flash_attention_backward.cu``): ``tools/kernel_variants.py
--against tools/kernel_variants/k6b_onepass`` loads its
``flash_attention_backward``, which sizes that design's scratch
(``_scratch_floats``: D, the turns and the f32 dQ sum).  The rest is the
package's module as it stood.

Kernel K6: causal or full GQA flash attention (forward), and its backward
K6', CUDA for Hopper.

Port of ``repro/kernels/flash_attention.py::flash_attention``; the sources
and their design notes are ``csrc/flash_attention.cu`` (K6) and
``csrc/flash_attention_backward.cu`` (K6', which has no Pallas counterpart:
the reference trains through XLA's autodiff of its jnp attention).
``flash_attention`` and ``flash_attention_backward`` launch on CUDA tensors
only; ``ops.flash_attention`` routes a CPU tensor to the plain versions
(``ref.flash_attention_ref``, ``ref.flash_attention_backward_ref``) and
wires the two kernels into autograd on the card.  Unlike the TPU kernel K6
takes any S (no ``block_q``/``block_k``), reads the ``[B, S, H, dh]``
layout through strides, and takes the head dims ``HEAD_DIMS[dtype]`` only.
On the ``meta`` device (the dry run) both wrappers check and allocate as on
the card, then report ``flash_attention_work`` /
``flash_attention_backward_work`` to ``kernels.work`` and launch nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import build, work

NAME = "flash_attention"
NAME_BWD = "flash_attention_backward"
# The kernels' instantiations (multiples of 16), by dtype: the same in both
# (16 and 32 are lm-small's and the registry's smoke configs', which the
# reference runs in bf16 compute by default).
HEAD_DIMS = {torch.float32: (16, 32, 64, 80, 96, 128),
             torch.bfloat16: (16, 32, 64, 80, 96, 128)}
MAX_SEQ = 2**31 - 256  # the kernels' positions (and the bf16 TMA coordinates) are int32
_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
    ctypes.c_void_p,
]
_ARGS_BWD = [ctypes.c_void_p] * 10 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
]
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_SYMBOLS_BWD = {torch.float32: "flash_attention_backward_f32",
                torch.bfloat16: "flash_attention_backward_bf16"}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
launches_f32 = 0  # of those, launches of the f32 kernel
launches_bwd = 0  # K6' calls (bf16: D, then dK/dV/dQ, then dq from the sum; f32: D, dK/dV, dQ)
launches_bwd_f32 = 0  # of those, f32 ones


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take: a dtype other than f32/bf16
    or mixed dtypes, shapes other than q [B,S,H,dh], k = v [B,S,Hkv,dh] with
    Hkv dividing H, a head dim outside ``HEAD_DIMS``, a last dim that is not
    contiguous, rows not on 16-byte boundaries: a start or a stride that is
    no multiple of 16 bytes (the bf16 kernel loads its tiles with TMA, the
    f32 kernel with 16-byte copies; both require both), or an S past
    ``MAX_SEQ``.  K6' takes the same.  All but the starts depend only on
    dtypes, shapes and strides, checked once for each (``_check_layout``)."""
    _check_layout(q.dtype, k.dtype, v.dtype, q.shape, k.shape, v.shape,
                  q.stride(), k.stride(), v.stride())
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        name = next(n for n, t in (("q", q), ("k", k), ("v", v)) if t.data_ptr() % 16)
        raise ValueError(f"{NAME}: {name} must start on a 16-byte boundary")


@functools.lru_cache(maxsize=1024)
def _check_layout(qt, kt, vt, q_shape, k_shape, v_shape, q_stride, k_stride, v_stride) -> None:
    if qt not in _SYMBOLS or kt != qt or vt != qt:
        raise TypeError(f"{NAME}: dtypes {qt}, {kt}, {vt}; "
                        "want one of f32 / bf16 for q, k and v")
    if len(q_shape) != 4 or len(k_shape) != 4 or k_shape != v_shape:
        raise ValueError(f"{NAME}: want q [B,S,H,dh] and k, v [B,S,Hkv,dh], got "
                         f"{tuple(q_shape)}, {tuple(k_shape)}, {tuple(v_shape)}")
    B, S, H, dh = q_shape
    if (k_shape[0], k_shape[1], k_shape[3]) != (B, S, dh) or H % k_shape[2]:
        raise ValueError(f"{NAME}: k/v {tuple(k_shape)} do not fit q {tuple(q_shape)}"
                         " (same B, S, dh; Hkv divides H)")
    if dh not in HEAD_DIMS[qt]:
        raise ValueError(f"{NAME}: head dim {dh} not in {HEAD_DIMS[qt]} for "
                         f"{str(qt)[6:]}")
    if S > MAX_SEQ:
        raise ValueError(f"{NAME}: S = {S} past the kernel's {MAX_SEQ} positions")
    size = torch.tensor([], dtype=qt).element_size()
    for name, stride in (("q", q_stride), ("k", k_stride), ("v", v_stride)):
        if stride[3] != 1 or any(st * size % 16 for st in stride[:3]):
            raise ValueError(f"{NAME}: {name} strides {stride} — want a contiguous "
                             "head dim and rows on 16-byte boundaries")


# The bf16 kernel's work tile: query rows of one (b, h) (kRowsCta, csrc).
ROWS_CTA = 128


def k6_unit(B: int, S: int, H: int, causal: bool, u: int) -> list:
    """The ``(b, h, q-tile)`` work tiles of unit ``u`` of the bf16 kernel's
    walk (``Walk::tile`` in csrc/flash_attention.cu), in the order a CTA
    takes them: causal, the q-tiles ``n - 1 - p`` and ``p`` of one (b, h),
    the heavier first, and after all pairs the middle q-tile of an odd
    ``n``; full, each q-tile, the last first; (b, h) the slower index."""
    n_qt = -(-S // ROWS_CTA)
    pairs = n_qt // 2 if causal else 0
    singles = n_qt - 2 * pairs
    if u < B * H * pairs:
        bh, p = divmod(u, pairs)
        tiles = [(bh, n_qt - 1 - p), (bh, p)]
    else:
        bh, r = divmod(u - B * H * pairs, singles)
        tiles = [(bh, n_qt - 1 - pairs - r)]
    return [(bh // H, bh % H, qt) for bh, qt in tiles]


def k6_units(B: int, S: int, H: int, causal: bool) -> int:
    n_qt = -(-S // ROWS_CTA)
    return B * H * (n_qt - n_qt // 2 if causal else n_qt)


def k6_walk(B: int, S: int, H: int, ctas: int, causal: bool = True) -> list:
    """The bf16 kernel's walk, its twin: for each of the launch's CTAs
    (``ctas``, the SM count, or fewer where there are fewer units) the
    ``(b, h, q-tile)`` of every work tile it takes, in order: CTA c takes
    units c, c + grid, ... (``k6_unit``)."""
    units = k6_units(B, S, H, causal)
    grid = min(units, ctas)
    return [[t for u in range(c, units, grid) for t in k6_unit(B, S, H, causal, u)]
            for c in range(grid)]


def kept_pairs(S: int, causal: bool) -> int:
    """(query, key) pairs a head computes: the causal triangle or the square."""
    return S * (S + 1) // 2 if causal else S * S


def _products(dtype: torch.dtype, nominal: float) -> dict:
    """bf16 products on the tensor cores; f32 as 3xTF32, three tf32 products each."""
    return {"bf16": nominal} if dtype == torch.bfloat16 else {"tf32": 3.0 * nominal}


def flash_attention_work(q: torch.Tensor, k: torch.Tensor, causal: bool,
                         with_lse: bool) -> work.Work:
    """K6's work: q, k, v read and the output (and the [B, H, S] f32
    logsumexp) written once; two products (S = q k^T, then P v) of 2 dh
    operations a kept pair and head."""
    B, S, H, dh = q.shape
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size() + (B * H * S * 4 if with_lse else 0)
    return work.Work(bytes=moved, **_products(q.dtype, 4.0 * B * H * kept_pairs(S, causal) * dh))


def flash_attention_backward_work(q: torch.Tensor, k: torch.Tensor, causal: bool) -> work.Work:
    """K6''s work: q, k, v, o, dO and the logsumexp read once, dq, dk, dv
    written once; five products (S, dP, dV, dK, dQ) of 2 dh operations a
    kept pair and head, whatever the design recomputes."""
    B, S, H, dh = q.shape
    moved = (4 * q.numel() + 4 * k.numel()) * q.element_size() + B * H * S * 4
    return work.Work(bytes=moved, **_products(q.dtype, 10.0 * B * H * kept_pairs(S, causal) * dh))


_SAME_DEVICE = contextlib.nullcontext()


def _on_device(device: torch.device):
    """``torch.cuda.device(device)`` where it is not the current device
    already (entering it costs the host a few microseconds a launch)."""
    if device.type == "cuda" and device.index == torch._C._cuda_getDevice():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """The current stream of a CUDA device as the driver's handle, without
    the ``torch.cuda.Stream`` object that ``current_stream`` builds (7 us of
    host time a call on the card's host, PERF.md); other devices (the
    tests' faked launches) through ``current_stream``."""
    if device.type == "cuda":
        return torch._C._cuda_getCurrentRawStream(device.index)
    return torch.cuda.current_stream().cuda_stream


def _check_devices(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not (_on_cuda(tensors[0]) or work.on_meta(tensors[0])) \
            or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name} kernel takes CUDA tensors on one device, got "
            f"{', '.join(str(t.device) for t in tensors)}; ops.flash_attention routes CPU "
            "tensors to the plain versions")


def _strides(*tensors: torch.Tensor):
    return _strides_of(tuple(s for t in tensors for s in t.stride()[:3]))


@functools.lru_cache(maxsize=1024)
def _strides_of(strides: tuple):
    """The C array of a launch's strides, made once for each (never written)."""
    return (ctypes.c_longlong * len(strides))(*strides)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, lse: torch.Tensor | None = None) -> torch.Tensor:
    """q [B,S,H,dh], k/v [B,S,Hkv,dh], f32 | bf16 CUDA tensors -> [B,S,H,dh]
    in q's dtype: softmax(q k^T / sqrt(dh)) v per head, query head h reading
    KV head h // (H // Hkv), keys after the query masked when ``causal``.
    With ``lse``, a contiguous [B, H, S] f32 CUDA tensor, the kernel also
    writes each row's logsumexp of the scaled scores there: the input of
    K6', the backward."""
    global launches, launches_f32
    check_inputs(q, k, v)
    _check_devices(NAME, q, k, v)
    B, S, H, dh = q.shape
    if lse is not None:
        if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous() \
                or lse.device != q.device:
            raise ValueError(f"{NAME}: lse must be a contiguous [B, H, S] = {[B, H, S]} f32 "
                             f"tensor on {q.device}, got {tuple(lse.shape)} {lse.dtype} "
                             f"on {lse.device}")
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    names = (NAME, f"{NAME}_f32") if q.dtype == torch.float32 else (NAME,)
    work.kernel(names, flash_attention_work, q, k, causal, lse is not None)
    if work.on_meta(q):
        return out
    lib = build.load(NAME, {sym: _ARGS for sym in _SYMBOLS.values()})
    with _on_device(q.device):
        code = getattr(lib, _SYMBOLS[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], dh, int(causal), _strides(q, k, v, out),
            _stream(q.device),
            None if lse is None else lse.data_ptr(),
        )
    build.check(lib, NAME, code)
    launches += 1
    launches_f32 += q.dtype == torch.float32
    return out


# K6' bf16's tiles (csrc/flash_attention_backward.cu): keys a unit owns
# (kOwnRows) and query rows a step streams (kQueryStep).
ROWS_BWD = 128
STEP_BWD = 64


def _up32(n: int) -> int:
    return -(-n // 32) * 32


@functools.lru_cache(maxsize=1024)
def _scratch_floats(B: int, S: int, H: int, dh: int, bf16: bool) -> int:
    """f32 elements of K6''s scratch (the source's ``sum_at``): D [B, H,
    S]; in bf16 with more than one key tile also the turns [B, H, n_q] and
    the dQ sum [B, H, n_q, 64 x dh], each on a 128-byte boundary."""
    n = B * H * S
    if bf16 and S > ROWS_BWD:
        n_q = -(-S // STEP_BWD)
        n = _up32(_up32(n) + B * H * n_q) + B * H * n_q * STEP_BWD * dh
    return n


@functools.lru_cache(maxsize=1024)
def _check_grad_layout(shape, dtype, o_shape, o_dtype, o_stride, do_shape, do_dtype,
                       do_stride) -> None:
    """o and do against q: shape, dtype, a contiguous head dim and rows on
    16-byte boundaries (checked once for each)."""
    size = torch.tensor([], dtype=dtype).element_size()
    for name, sh, dt, st in (("o", o_shape, o_dtype, o_stride), ("do", do_shape, do_dtype,
                                                                  do_stride)):
        if sh != shape or dt != dtype:
            raise ValueError(f"{NAME_BWD}: {name} {tuple(sh)} {dt} must match q "
                             f"{tuple(shape)} {dtype}")
        if st[3] != 1 or any(x * size % 16 for x in st[:3]):
            raise ValueError(f"{NAME_BWD}: {name} strides {st} — want a contiguous "
                             "head dim and rows on 16-byte boundaries")


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True):
    """Kernel K6': ``(dq, dk, dv)``, the gradients of ``flash_attention``'s
    q, k and v from its output ``o``, its row logsumexp ``lse`` ([B, H, S]
    f32, contiguous) and ``do``, the gradient of ``o``; all CUDA tensors of
    q's dtype but ``lse``, ``o`` and ``do`` shaped as q and taken by strides
    as K6 takes q.  Returns new contiguous tensors in q's dtype, dk and dv
    summed over each KV head's group of query heads (dk and dv are the two
    halves of one allocation).  Deterministic: the bf16 kernel sums dQ
    across key tiles in a fixed order, the f32 kernels own every output
    element."""
    global launches_bwd, launches_bwd_f32
    check_inputs(q, k, v)
    _check_grad_layout(q.shape, q.dtype, o.shape, o.dtype, o.stride(), do.shape, do.dtype,
                       do.stride())
    if o.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError(f"{NAME_BWD}: o and do must start on 16-byte boundaries")
    B, S, H, dh = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{NAME_BWD}: lse must be a contiguous [B, H, S] = {[B, H, S]} f32 "
                         f"tensor, got {tuple(lse.shape)} {lse.dtype}")
    _check_devices(NAME_BWD, q, k, v, o, lse, do)
    dq = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    dk, dv = torch.empty((2, *k.shape), dtype=q.dtype, device=q.device).unbind()
    scratch = torch.empty(_scratch_floats(B, S, H, dh, q.dtype == torch.bfloat16),
                          dtype=torch.float32, device=q.device)
    names = (NAME_BWD, f"{NAME_BWD}_f32") if q.dtype == torch.float32 else (NAME_BWD,)
    work.kernel(names, flash_attention_backward_work, q, k, causal)
    if work.on_meta(q):
        return dq, dk, dv
    lib = build.load(NAME_BWD, {sym: _ARGS_BWD for sym in _SYMBOLS_BWD.values()})
    with _on_device(q.device):
        code = getattr(lib, _SYMBOLS_BWD[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, k.shape[2], dh, int(causal), _strides(q, k, v, o, do),
            _stream(q.device),
        )
    build.check(lib, NAME_BWD, code)
    launches_bwd += 1
    launches_bwd_f32 += q.dtype == torch.float32
    return dq, dk, dv
