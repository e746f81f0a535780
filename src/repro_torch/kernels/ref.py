"""Plain PyTorch versions of the hand-written kernels.

The CPU tests and ``chip_smoke.py`` hold the kernels against these; a kernel
wrapper takes them only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import math

import torch


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 accumulation for f32 and bf16 inputs; f64 for f64 (gradient checks)."""
    return torch.promote_types(t.dtype, torch.float32)


def embedding_bag_ref(
    table: torch.Tensor,  # [V, D]
    indices: torch.Tensor,  # [N] int32 row ids (N = num_bags * nnz)
    weights: torch.Tensor,  # [N] f32 per-slot weights
    num_bags: int,
    masked: bool = False,
) -> torch.Tensor:
    """[num_bags, D] f32 weighted sums over fixed-nnz bags (FBGEMM TBE
    semantics), rows upcast to f32 (f64 stays f64) and ids clamped into [0, V).

    Weighted (the Pallas kernel's contract): every row multiplied by its
    weight, so a NaN row behind w = 0 gives NaN.  Masked: a slot whose
    weight is 0 adds exactly 0 and its id is never used, as the reference
    lookup's masked gather (``where(w != 0, w * row, 0)``)."""
    acc = _acc_dtype(table)
    w = weights.to(acc)
    ids = indices.long().clamp(0, table.shape[0] - 1)
    if masked:
        ids = torch.where(w != 0, ids, 0)
    rows = table.index_select(0, ids).to(acc) * w[:, None]
    if masked:
        rows = torch.where((w != 0)[:, None], rows, 0.0)
    nnz = indices.shape[0] // num_bags
    return rows.reshape(num_bags, nnz, -1).sum(dim=1)


def dot_interaction_ref(x: torch.Tensor) -> torch.Tensor:
    """[B, F, D] -> [B, F, F] pairwise dot (gram) matrix, f32 accumulation
    (f64 stays f64)."""
    xf = x.to(_acc_dtype(x))
    return torch.bmm(xf, xf.transpose(1, 2))


def embedding_bag_backward_ref(
    grad_out: torch.Tensor,  # [num_bags, D]
    indices: torch.Tensor,  # [N] int32
    weights: torch.Tensor,  # [N] f32
    num_rows: int,
    masked: bool = False,
) -> torch.Tensor:
    """[num_rows, D] f32 (f64 stays f64) gradient of ``embedding_bag_ref``'s table:
    ``grad[clamp(idx[s])] += w[s] * grad_out[s // nnz]``, in slot order.
    Masked: a slot whose weight is 0 adds nothing and its id is not used."""
    acc = _acc_dtype(grad_out)
    w = weights.to(acc)
    nnz = indices.shape[0] // grad_out.shape[0]
    ids = indices.long().clamp(0, num_rows - 1)
    contrib = grad_out.to(acc).repeat_interleave(nnz, dim=0) * w[:, None]
    if masked:
        live = w != 0
        ids, contrib = ids[live], contrib[live]
    grad = torch.zeros((num_rows, grad_out.shape[1]), dtype=acc, device=grad_out.device)
    return grad.index_add_(0, ids, contrib)


def dot_interaction_backward_ref(x: torch.Tensor, grad_tri: torch.Tensor) -> torch.Tensor:
    """[B, F, D] f32 (f64 stays f64) gradient of x from the gradient of its gram matrix's
    upper triangle [B, F(F+1)/2] (``np.triu_indices`` order): (G + G^T) x,
    G the triangle laid into [F, F]."""
    B, F, _ = x.shape
    iu, ju = torch.triu_indices(F, F, device=x.device)
    acc = _acc_dtype(x)
    g = torch.zeros((B, F, F), dtype=acc, device=x.device)
    g[:, iu, ju] = grad_tri.to(acc)
    return torch.bmm(g + g.transpose(1, 2), x.to(acc))


NEG_INF = -1e30  # the masked score of the reference's attention


def flash_attention_ref(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, S, Hkv, dh]
    v: torch.Tensor,  # [B, S, Hkv, dh]
    causal: bool = True,
    q_block: int = 512,
    return_lse: bool = False,
):
    """[B, S, H, dh] in q's dtype: exact GQA attention chunked over blocks of
    ``q_block`` queries, as the reference's ``layers.gqa_prefill_attention``
    (f32 scores scaled by 1/sqrt(dh), masked to -1e30, softmax, probs rounded
    to v's dtype, f32 accumulation).  Query head h reads KV head
    h // (H // Hkv) by reshape, KV is never repeated.  A causal block scores
    only the keys up to its last query: the keys it skips are masked, and
    their exp(-1e30 - max) is exactly 0 either way.  With ``return_lse``
    also each row's logsumexp ``[B, H, S]`` f32 of the scaled scores, m +
    log l (m the row's max, l the sum of exp(s - m)), as K6 writes it for
    its backward."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    acc = _acc_dtype(q)
    kt = k.to(acc).permute(0, 2, 3, 1)[:, :, None]  # [B,Hkv,1,dh,S]
    vt = v.permute(0, 2, 1, 3)[:, :, None]  # [B,Hkv,1,S,dh]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=acc, device=q.device) if return_lse else None
    for s0 in range(0, S, q_block):
        n = min(q_block, S - s0)
        n_keys = s0 + n if causal else S
        qb = q[:, s0:s0 + n].to(acc).reshape(B, n, Hkv, g, dh)
        scores = qb.permute(0, 2, 3, 1, 4) @ kt[..., :n_keys] * scale  # [B,Hkv,g,n,keys]
        if causal:
            qpos = torch.arange(s0, s0 + n, device=q.device)
            kpos = torch.arange(n_keys, device=q.device)
            scores = scores.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype).to(acc)
        ob = probs @ vt[:, :, :, :n_keys].to(acc)  # [B,Hkv,g,n,dh]
        out[:, s0:s0 + n] = ob.permute(0, 3, 1, 2, 4).reshape(B, n, H, dh).to(q.dtype)
        if lse is not None:
            m = scores.amax(dim=-1, keepdim=True)
            l_sum = torch.exp(scores - m).sum(dim=-1)
            lse[:, :, s0:s0 + n] = (m[..., 0] + torch.log(l_sum)).reshape(B, H, n)
    return (out, lse) if return_lse else out


def flash_attention_backward_ref(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, S, Hkv, dh]
    v: torch.Tensor,  # [B, S, Hkv, dh]
    o: torch.Tensor,  # [B, S, H, dh]: the forward's output
    lse: torch.Tensor,  # [B, H, S] f32: the forward's row logsumexp
    do: torch.Tensor,  # [B, S, H, dh]: the gradient of o
    causal: bool = True,
    k_block: int = 512,
):
    """``(dq, dk, dv)`` in q's dtype: the gradient of ``flash_attention_ref``
    by the flash-attention backward's algebra, in f32 (f64 stays f64),
    chunked over blocks of ``k_block`` keys: D = rowsum(do o); per key
    block P = exp(q k^T / sqrt(dh) - lse) (0 where masked), dV = P^T do with
    P rounded to v's dtype as the forward's P . V takes it, dP = do v^T,
    dS = P (dP - D), dQ += dS k / sqrt(dh), dK = dS^T q / sqrt(dh).  dK and
    dV sum over each KV head's group of query heads.  Kernel K6' computes
    the same."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    acc = _acc_dtype(q)

    def heads(t):  # [B, S, H, dh] -> [B, Hkv, g, S, dh]
        return t.to(acc).reshape(B, S, Hkv, g, dh).permute(0, 2, 3, 1, 4)

    qh, gh = heads(q), heads(do)
    delta = (gh * heads(o)).sum(-1)  # [B, Hkv, g, S]
    lse_h = lse.to(acc).reshape(B, Hkv, g, S)
    kh = k.to(acc).permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, S, dh]
    vh = v.to(acc).permute(0, 2, 1, 3)[:, :, None]
    dq = torch.zeros_like(qh)
    dk = torch.empty((B, Hkv, S, dh), dtype=acc, device=q.device)
    dv = torch.empty_like(dk)
    qpos = torch.arange(S, device=q.device)
    for k0 in range(0, S, k_block):
        n = min(k_block, S - k0)
        r0 = k0 if causal else 0  # rows before the block see none of its keys
        kb, vb = kh[:, :, :, k0:k0 + n], vh[:, :, :, k0:k0 + n]
        qb, gb = qh[:, :, :, r0:], gh[:, :, :, r0:]
        s = qb @ kb.transpose(-1, -2) * scale  # [B, Hkv, g, S - r0, n]
        p = torch.exp(s - lse_h[..., r0:, None])
        if causal:
            kpos = torch.arange(k0, k0 + n, device=q.device)
            p = p.masked_fill(kpos[None, :] > qpos[r0:, None], 0.0)
        dv[:, :, k0:k0 + n] = (p.to(v.dtype).to(acc).transpose(-1, -2) @ gb).sum(2)
        ds = p * (gb @ vb.transpose(-1, -2) - delta[..., r0:, None])
        dq[:, :, :, r0:] += ds @ kb * scale
        dk[:, :, k0:k0 + n] = (ds.transpose(-1, -2) @ qb).sum(2) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(q.dtype),
            dv.permute(0, 2, 1, 3).to(q.dtype))


def flash_decode_ref(
    q: torch.Tensor,  # [B, H, dh]
    k_cache: torch.Tensor,  # [B, S, Hkv, dh]
    v_cache: torch.Tensor,
    cache_len,  # int or one-element int tensor: the valid prefix
) -> torch.Tensor:
    """[B, H, dh] in q's dtype: the reference's single-device
    ``layers.flash_decode_shard`` (f32 scores, -inf past ``cache_len``, the
    safe max, probs rounded to v's dtype, out / max(l, 1e-30)).  Rows at or
    past ``cache_len`` are masked out of the scores and the values, so
    whatever they hold (NaN included) never reaches the output."""
    B, S, Hkv, dh = k_cache.shape
    H = q.shape[1]
    g = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qr = q.to(torch.float32).reshape(B, Hkv, g, dh)
    valid = torch.arange(S, device=q.device) < torch.as_tensor(cache_len, device=q.device)
    scores = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.to(torch.float32)) * scale
    scores = scores.masked_fill(~valid, float("-inf"))
    local_max = scores.amax(dim=-1)  # [B,Hkv,g]
    safe_max = torch.where(torch.isfinite(local_max), local_max, 0.0)
    probs = torch.exp(scores - safe_max[..., None])
    probs = torch.where(valid, probs, 0.0)
    l_sum = probs.sum(dim=-1)
    vf = torch.where(valid[None, :, None, None], v_cache, 0).to(torch.float32)
    o = torch.einsum("bhgs,bshd->bhgd", probs.to(v_cache.dtype).to(torch.float32), vf)
    out = o / torch.clamp_min(l_sum[..., None], 1e-30)
    return out.reshape(B, H, dh).to(q.dtype)


def flash_decode_partial_ref(
    q: torch.Tensor,  # [B, H, dh]
    k_local: torch.Tensor,  # [B, S, Hkv, dh]: positions shard_start ..
    v_local: torch.Tensor,
    cache_len,  # int or one-element int tensor: the valid prefix of the whole cache
    shard_start,  # int or one-element int tensor: the global position of row 0
):
    """The shard's partials of the reference's ``layers.flash_decode_shard``
    before its combine (src/repro/models/layers.py:189-207):
    ``(o [B,H,dh] f32, m [B,H] f32, l [B,H] f32)``, with positions
    ``shard_start + i < cache_len`` valid, f32 scores, ``m`` their max (-inf
    on a shard with no valid row), ``p = exp(s - m)`` (0 where masked), ``l``
    the sum of ``p`` and ``o`` the f32 sum of ``p`` rounded to v's dtype times
    the rows.  Rows at or past ``cache_len`` never reach the output."""
    B, S, Hkv, dh = k_local.shape
    H = q.shape[1]
    g = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qr = q.to(torch.float32).reshape(B, Hkv, g, dh)
    start = torch.as_tensor(shard_start, device=q.device).reshape(())
    pos = start + torch.arange(S, device=q.device)
    valid = pos < torch.as_tensor(cache_len, device=q.device).reshape(())
    scores = torch.einsum("bhgd,bshd->bhgs", qr, k_local.to(torch.float32)) * scale
    scores = scores.masked_fill(~valid, float("-inf"))
    local_max = scores.amax(dim=-1)  # [B,Hkv,g]
    safe_max = torch.where(torch.isfinite(local_max), local_max, 0.0)
    probs = torch.where(valid, torch.exp(scores - safe_max[..., None]), 0.0)
    vf = torch.where(valid[None, :, None, None], v_local, 0).to(torch.float32)
    o = torch.einsum("bhgs,bshd->bhgd", probs.to(v_local.dtype).to(torch.float32), vf)
    return o.reshape(B, H, dh), local_max.reshape(B, H), probs.sum(dim=-1).reshape(B, H)
