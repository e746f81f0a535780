"""Mixture-of-Experts layer with expert sharding over the `model` axis.

Port of ``repro/models/moe.py``.  Dispatch strategy (and its FlexEMR
connection): token activations are replicated across the `model` axis
(they are split over the batch axes only), so every expert shard can
*locally* select the tokens routed to its experts, run its expert FFNs and
contribute a partial token output; one all-reduce over `model` combines the
partials (``models.transformer``'s layers).  That is the paper's
hierarchical-pooling pattern applied to expert fan-out: each "server"
(expert shard) reduces what it owns, and only [T, D]-sized partials cross
the network, never the dispatched [E, C, D] buffers.

Routing is the reference's capacity-factor top-k scheme with in-shard
ranking (sort-free: ranks by cumulative sums over the one-hot expert
assignment), dropping overflow tokens, plus the Switch-style load-balancing
auxiliary loss.  The top k is a stable descending sort, so ties go to the
lowest expert index as ``jax.lax.top_k`` breaks them (``torch.topk``
promises no order): the indices route tokens and must match.  The expert
products are batched matrix products (``torch.bmm``), as the reference
leaves its ``einsum``s to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def moe_init(gen: torch.Generator, cfg: MoEConfig, d_model: int, dtype=torch.float32,
             device="cuda") -> dict:
    """The reference's shapes and scales (router uniform in +-1/sqrt(D);
    expert weights normal / sqrt(fan_in)), drawn from ``gen`` on ``device``."""
    dev = resolve_device(device)
    E, Fd = cfg.num_experts, cfg.d_ff

    def nrm(shape, fan_in):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev).div_(math.sqrt(fan_in))

    return {
        "router": dense_init(gen, d_model, E, dtype, dev),
        "w_gate": nrm((E, d_model, Fd), d_model),
        "w_up": nrm((E, d_model, Fd), d_model),
        "w_down": nrm((E, Fd, d_model), Fd),
    }


def moe_capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots per expert: tokens x top_k x capacity_factor / experts, rounded
    up to a multiple of 8, at least 8."""
    cap = int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts))
    return max(8, ((cap + 7) // 8) * 8)


def moe_route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
              num_expert_shards: int = 1, expert_shard: int | None = None):
    """The routing of ``moe_apply_local`` (reference moe.py:67-100):
    ``(top_p [T,K] f32, top_e [T,K] int64, slots [K,T] int64, aux [] f32)``.
    ``slots[k, t]`` is assignment (t, k)'s row of the local dispatch buffer,
    ``local_e * C + rank``, or the sentinel ``E_loc * C`` when it is dropped
    (rank >= C) or routed to another shard's experts."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    E_loc = E // num_expert_shards
    C = moe_capacity(cfg, T)

    logits = (x @ router.to(x.dtype)).to(torch.float32)  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # Intra-expert rank of each (token, k) assignment, sort-free: the
    # reference's per-k cumulative counts with a carried base are one
    # cumulative count over the assignments in k-major order (all of k = 0,
    # then k = 1, ...).  The one-hot is laid out [E, K T] and summed along
    # its rows: a scan of the contiguous dim, and no F.one_hot, whose range
    # check waits for the device.
    top_e_kt = top_e.T  # [K, T]
    e_flat = top_e_kt.reshape(-1)
    onehot = (e_flat[None, :] == torch.arange(E, device=x.device)[:, None]).to(torch.int32)
    rank = onehot.cumsum(1, dtype=torch.int32).gather(0, e_flat[None, :])[0] - 1
    rank = rank.reshape(K, T)
    keep = rank < C
    if expert_shard is None:
        local_mask, local_e = keep, top_e_kt
    else:
        local_mask = keep & (top_e_kt // E_loc == expert_shard)
        local_e = top_e_kt - expert_shard * E_loc
    slots = torch.where(local_mask, local_e * C + rank, E_loc * C)  # [K, T]

    # Switch aux loss: fraction of tokens per expert * mean router prob.
    me = probs.mean(dim=0)  # [E]
    ce = onehot[:, :T].sum(1).to(torch.float32) / T
    aux = cfg.aux_loss_weight * E * torch.sum(me * ce)
    return top_p, top_e, slots, aux


def moe_apply_local(
    params: dict,
    x: torch.Tensor,  # [T, D]: this batch block's tokens (replicated over model)
    cfg: MoEConfig,
    num_expert_shards: int,
    expert_shard: int | None,  # this rank's index on `model`, or None (one device)
):
    """Returns ``(partial_out [T, D], aux_loss)``; the caller all-reduces
    ``partial_out`` over the `model` axis (the hierarchical combine).

    When ``expert_shard`` is not None, the expert weights in ``params`` are
    already the LOCAL shard: w_gate/w_up [E_loc, D, F], w_down [E_loc, F, D].
    The router is always whole."""
    T, D = x.shape
    E_loc = cfg.num_experts // num_expert_shards
    C = moe_capacity(cfg, T)
    top_p, _, slots, aux = moe_route(params["router"], x, cfg, num_expert_shards,
                                     expert_shard)

    # Scatter tokens into the local dispatch buffer [E_loc * C + 1, D], all
    # k at once (x broadcast over k): real slots are unique, every drop
    # writes the sentinel row, which is cut off.
    buf = torch.zeros((E_loc * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slots] = x
    buf = buf[: E_loc * C].reshape(E_loc, C, D)

    # Expert FFNs (SwiGLU) over this shard's (already local) experts.
    wg = params["w_gate"].to(x.dtype)
    wu = params["w_up"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    if wg.shape[0] != E_loc:
        raise ValueError(f"moe_apply_local: {wg.shape[0]} experts given, the local shard "
                         f"has {E_loc}: expert weights must be the local shard")
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd)  # [E_loc, C, D]

    # Combine: gather each assignment's expert output, weighted by its gate
    # probability in x's dtype, summed in k order.
    out_flat = torch.cat([out_buf.reshape(E_loc * C, D),
                          torch.zeros((1, D), dtype=x.dtype, device=x.device)])
    partial = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for kk in range(cfg.top_k):
        partial = partial + out_flat[slots[kk]] * top_p[:, kk, None].to(x.dtype)
    return partial, aux


def moe_apply_reference(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """Single-device oracle (no sharding, no drops beyond capacity)."""
    return moe_apply_local(params, x, cfg, num_expert_shards=1, expert_shard=None)
