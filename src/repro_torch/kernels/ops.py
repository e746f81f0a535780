"""Public kernel entry points, dispatched by the tensor's device.

Three routes.  A CUDA tensor goes to the hand-written kernel
(``embedding_bag.py``, ``dot_interaction.py``, ``flash_attention.py``,
``flash_decode.py``), a CPU tensor to the plain version in ``ref.py``.  A
``meta`` tensor (the dry run, ``launch.dryrun``) takes the card's route, the
same ``autograd.Function``s and wrapper code up to the launch, where the
wrapper reports the kernel's work (``kernels.work``) and launches nothing;
it never takes the plain versions, whose intermediates are not the
kernel's work.  Any other device, or tensors on two devices, raise.  There
is no switch and no fallback: on the card the plain version is never taken,
and a failed build or launch raises.

Gradients: on the card, where a gradient is needed, K1, K2 and K6 run
inside ``torch.autograd.Function``s whose backwards are the hand-written
kernels K1' (``embedding_bag.embedding_bag_backward``), K2'
(``dot_interaction.dot_interaction_backward``) and K6'
(``flash_attention.flash_attention_backward``, from K6's output and row
logsumexp); on the CPU autograd differentiates the plain versions.  On
both, a gradient for K1's weights, for a table that is not f32 or for a K2
input that is not f32 raises: no trainer trains them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dot_interaction as K2
from repro_torch.kernels import embedding_bag as K1
from repro_torch.kernels import flash_attention as K6
from repro_torch.kernels import flash_decode as K7
from repro_torch.kernels import ref


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route: CUDA, or meta (the dry run)."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device} (cuda | cpu | meta)")


def same_device_type(*tensors) -> None:
    """Raise unless every tensor given (``None`` skipped) is on one kind of
    device: a meta tensor beside a CPU one takes neither route."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) > 1:
        raise ValueError(f"tensors on {sorted(kinds)}: one device type a call")


class _EmbeddingBag(torch.autograd.Function):
    """K1 forward, K1' backward: the table's gradient only."""

    @staticmethod
    def forward(ctx, table, indices, weights, num_bags, masked):
        ctx.save_for_backward(indices, weights)
        ctx.num_rows, ctx.masked = table.shape[0], masked
        return K1.embedding_bag(table, indices, weights, num_bags, masked=masked)

    @staticmethod
    def backward(ctx, grad_out):
        indices, weights = ctx.saved_tensors
        grad = K1.embedding_bag_backward(grad_out.contiguous(), indices, weights,
                                         ctx.num_rows, masked=ctx.masked)
        return grad, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def embedding_bag(table, indices, weights, num_bags, masked: bool = False):
    """K1 in its weighted mode (the Pallas kernel's contract) or, with
    ``masked``, skipping every slot whose weight is 0 (``ref.embedding_bag_ref``).
    Differentiable in the table (f32 only) on both devices."""
    same_device_type(table, indices, weights)
    if _needs_grad(weights):
        raise ValueError("embedding_bag: no gradient for the weights (K1' computes "
                         "the table's only); pass weights that do not require grad")
    if _needs_grad(table) and table.dtype != torch.float32:
        raise TypeError(f"embedding_bag: a {table.dtype} table that requires grad; "
                        "only f32 tables train")
    if _is_cuda(table):
        if _needs_grad(table):
            return _EmbeddingBag.apply(table, indices, weights, num_bags, masked)
        return K1.embedding_bag(table, indices, weights, num_bags, masked=masked)
    return ref.embedding_bag_ref(table, indices, weights, num_bags, masked=masked)


def bag_lookup(
    table: torch.Tensor,
    indices: torch.Tensor,  # [B, F, nnz]; K1 clamps ids into [0, V)
    mask: torch.Tensor,  # [B, F, nnz] bool
    masked: bool = False,
) -> torch.Tensor:
    """[B,F,nnz] multi-hot lookup -> [B,F,D] f32 sum-pooled, via kernel K1.
    The mask rides as 0/1 weights; with ``masked`` a masked slot's row is
    never read (``DisaggEmbedding.lookup``), without it every row is
    multiplied by its weight, as the reference's ``ops.bag_lookup``."""
    B, F, nnz = indices.shape
    flat_idx = indices.reshape(-1).to(torch.int32).contiguous()
    flat_w = mask.reshape(-1).to(torch.float32).contiguous()
    out = embedding_bag(table, flat_idx, flat_w, B * F, masked=masked)
    return out.reshape(B, F, table.shape[1])


def _triu(prods: torch.Tensor) -> torch.Tensor:
    F = prods.shape[1]
    iu, ju = torch.triu_indices(F, F, device=prods.device)
    return prods[:, iu, ju]


class _DotInteractionTriu(torch.autograd.Function):
    """K2 and the triangle gather forward, K2' backward from the triangle's
    gradient (no [B, F, F] scatter)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _triu(K2.dot_interaction(x))

    @staticmethod
    def backward(ctx, grad_tri):
        (x,) = ctx.saved_tensors
        return K2.dot_interaction_backward(x, grad_tri.contiguous())


def dot_interaction_triu(x: torch.Tensor) -> torch.Tensor:
    """[B,F,D] -> [B, F*(F+1)/2] upper-triangle (incl. diag) pairwise dots,
    row-major as ``np.triu_indices(F)`` orders them; the gram matrix comes
    from kernel K2.  Differentiable (f32 only) on both devices."""
    same_device_type(x)
    if _needs_grad(x) and x.dtype != torch.float32:
        raise TypeError(f"dot_interaction_triu: a {x.dtype} input that requires grad; "
                        "K2' takes f32 only")
    if _is_cuda(x):
        if _needs_grad(x):
            return _DotInteractionTriu.apply(x)
        return _triu(K2.dot_interaction(x))
    return _triu(ref.dot_interaction_ref(x))


class _FlashAttention(torch.autograd.Function):
    """K6 forward, writing each row's logsumexp beside its output; K6'
    backward from q, k, v, the output and the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = K6.flash_attention(q, k, v, causal, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = K6.flash_attention_backward(q, k, v, out, lse, grad_out.contiguous(),
                                                 ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """q [B,S,H,dh], k/v [B,S,Hkv,dh] -> [B,S,H,dh] GQA attention, kernel K6
    on the card; differentiable in q, k and v on both devices (K6' on the
    card)."""
    same_device_type(q, k, v)
    if _is_cuda(q):
        if _needs_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal)
        return K6.flash_attention(q, k, v, causal)
    return ref.flash_attention_ref(q, k, v, causal)


def flash_decode(q, k_cache, v_cache, cache_len):
    """q [B,H,dh] against caches [B,S,Hkv,dh] up to ``cache_len`` (an int32
    tensor of one element on the caches' device) -> [B,H,dh], kernel K7 on
    the card."""
    same_device_type(q, k_cache, v_cache, cache_len)
    if _is_cuda(q):
        return K7.flash_decode(q, k_cache, v_cache, cache_len)
    return ref.flash_decode_ref(q, k_cache, v_cache, cache_len)


def flash_decode_partial(q, k_local, v_local, cache_len, shard_start):
    """One shard's partials for the sequence-sharded decode: q [B,H,dh]
    against caches [B,S,Hkv,dh] that hold positions ``shard_start ..`` of
    the whole cache, valid below ``cache_len`` (both int32 tensors of one
    element on the caches' device) -> ``(o [B,H,dh] f32, m [B,H] f32,
    l [B,H] f32)``, un-normalised: kernel K7's shard mode on the card."""
    same_device_type(q, k_local, v_local, cache_len, shard_start)
    if _is_cuda(q):
        return K7.flash_decode_partial(q, k_local, v_local, cache_len, shard_start)
    return ref.flash_decode_partial_ref(q, k_local, v_local, cache_len, shard_start)
