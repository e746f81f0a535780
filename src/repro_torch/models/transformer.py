"""Decoder-only dense LM (GQA, RMSNorm, rotary, SwiGLU) on one device.

Port of ``repro/models/transformer.py`` for its single-device serving path:
``prefill`` (a whole prompt; attention is kernel K6 on the card) and
``decode_step`` (one token against the KV cache; attention is kernel K7).
Parameters are a nested dict of tensors with the reference's keys and its
``[L, ...]``-stacked layer layout, so ``params_from_numpy`` carries the
reference's weights across unchanged.  The layers run as a Python loop (no
scan, no remat: serving keeps no activations for a backward pass).

Not ported yet (ROADMAP queue 1, item 4): experts (``moe``), the training
path (``lm_loss``, ``make_train_step``), the mesh paths (``param_specs``,
``cache_specs``, tensor and sequence parallelism, the sequence-sharded
decode combine), on the mesh layer that item 2 ported (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.utils import numpy_to_tensor, resolve_device, round_up, tree_map


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config cut to the fields the single-device serving
    path reads; sharding, remat and expert fields come back with the slices
    that port their code."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    def padded_heads(self) -> int:
        """Heads padded to the tensor-parallel degree: 1 on one device."""
        return self.n_heads

    def padded_vocab(self) -> int:
        return round_up(self.vocab, 128)

    def num_params(self) -> int:
        D, F, Vp = self.d_model, self.d_ff, self.padded_vocab()
        Hd = self.padded_heads() * self.d_head
        Kd = self.n_kv_heads * self.d_head
        per_layer = D * Hd + 2 * D * Kd + Hd * D + 2 * D + 3 * D * F
        return self.n_layers * per_layer + 2 * Vp * D + D


# ------------------------------------------------------------------ params


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's shapes, dtypes and scales
    (normal / sqrt(fan_in); the embedding normal * 0.02; norms 1; biases 0),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``
    (raises when ``device`` is CUDA and no GPU is present).  The numbers
    differ from the reference's ``jax.random``; parity tests carry the
    reference's weights across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, dh, Hp, Hkv = cfg.d_model, cfg.d_head, cfg.padded_heads(), cfg.n_kv_heads
    Lyr, Vp, dt = cfg.n_layers, cfg.padded_vocab(), cfg.param_dtype

    def nrm(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=dt, device=dev)
        return w.div_(math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    lyr = {
        "ln1": ones((Lyr, D)),
        "ln2": ones((Lyr, D)),
        "wq": nrm((Lyr, D, Hp * dh), D),
        "wk": nrm((Lyr, D, Hkv * dh), D),
        "wv": nrm((Lyr, D, Hkv * dh), D),
        "wo": nrm((Lyr, Hp * dh, D), Hp * dh),
    }
    if cfg.qkv_bias:
        lyr["bq"] = torch.zeros((Lyr, Hp * dh), dtype=dt, device=dev)
        lyr["bk"] = torch.zeros((Lyr, Hkv * dh), dtype=dt, device=dev)
        lyr["bv"] = torch.zeros((Lyr, Hkv * dh), dtype=dt, device=dev)
    lyr["wg"] = nrm((Lyr, D, cfg.d_ff), D)
    lyr["wu"] = nrm((Lyr, D, cfg.d_ff), D)
    lyr["wd"] = nrm((Lyr, cfg.d_ff, D), cfg.d_ff)
    return {
        "embed": nrm((Vp, D), 1.0).mul_(0.02),
        "layers": lyr,
        "final_ln": ones((D,)),
        "head": nrm((Vp, D), D),
    }


def params_from_numpy(cfg: TransformerConfig, np_params: dict, device) -> dict:
    """The reference's parameter tree (``np.asarray`` on each leaf) as this
    package's nested dict of tensors on ``device``, keys and ``[L, ...]``
    layer stacking kept."""
    dev = resolve_device(device)
    for name, leaf in np_params["layers"].items():
        if np.shape(leaf)[0] != cfg.n_layers:
            raise ValueError(f"layers[{name!r}] stacks {np.shape(leaf)[0]} layers, "
                             f"config {cfg.name!r} has {cfg.n_layers}")
    return tree_map(lambda a: numpy_to_tensor(np.asarray(a)).to(dev), np_params)


def layer_params(params: dict, li: int) -> dict:
    """Layer ``li``'s weights: views into the stacked ``[L, ...]`` tensors."""
    return {k: v[li] for k, v in params["layers"].items()}


# ------------------------------------------------------------------ forward


def _ffn(cfg: TransformerConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    g = torch.nn.functional.silu(h @ lp["wg"].to(dt)) * (h @ lp["wu"].to(dt))
    return g @ lp["wd"].to(dt)


def _layer_forward(cfg: TransformerConfig, x: torch.Tensor, lp: dict,
                   positions: torch.Tensor):
    """One transformer block over a whole sequence. x: [B,S,D]."""
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    Hp, Hkv, dh = cfg.padded_heads(), cfg.n_kv_heads, cfg.d_head
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = h @ lp["wq"].to(dt)
    k = h @ lp["wk"].to(dt)
    v = h @ lp["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    q = L.apply_rope(q.reshape(B, S, Hp, dh), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, Hkv, dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, dh)
    # GQA by index inside the attention (the reference repeats KV to the
    # padded head count for its 16-way mesh; the math is the same).
    attn = L.gqa_prefill_attention(q, k, v, causal=True)
    x = x + attn.reshape(B, S, Hp * dh) @ lp["wo"].to(dt)
    x = x + _ffn(cfg, lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x, k, v


def _hidden(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            return_cache: bool):
    """Final-normed hidden states [B,S,D] and, if asked, the KV caches
    [L,B,S,Hkv,dh] in the compute dtype."""
    dt = cfg.compute_dtype
    B, S = tokens.shape
    x = L.sharded_vocab_embed(params["embed"], tokens, None, out_dtype=dt)
    positions = torch.arange(S, device=tokens.device)[None, :]
    caches = None
    if return_cache:
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
        caches = (torch.empty(shape, dtype=dt, device=tokens.device),
                  torch.empty(shape, dtype=dt, device=tokens.device))
    for li in range(cfg.n_layers):
        x, k, v = _layer_forward(cfg, x, layer_params(params, li), positions)
        if caches is not None:
            caches[0][li] = k
            caches[1][li] = v
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps), caches


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            return_cache: bool = False):
    """Full-sequence forward over tokens [B, S] on the params' device.
    Returns ``(logits [B,S,Vp], aux_loss)`` and, with ``return_cache``, the
    KV caches ``(k_cache, v_cache)`` [L,B,S,Hkv,dh] as a third element.
    ``aux_loss`` is 0: the experts' balance loss comes with ``moe``."""
    x, caches = _hidden(cfg, params, tokens, return_cache)
    logits = x @ params["head"].to(cfg.compute_dtype).T
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return (logits, aux, caches) if return_cache else (logits, aux)


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """Prefill: last-position logits [B, Vp] and the KV caches
    [L,B,S,Hkv,dh].  Only the last position goes through the LM head (the
    reference computes every position's logits and keeps the last)."""
    x, caches = _hidden(cfg, params, tokens, return_cache=True)
    return x[:, -1] @ params["head"].to(cfg.compute_dtype).T, caches


# ------------------------------------------------------------------- decode


def init_decode_cache(cfg: TransformerConfig, batch: int, max_len: int,
                      dtype=None, device="cuda"):
    """Zeroed K and V caches [L, batch, max_len, Hkv, dh] on ``device``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.compute_dtype
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def decode_step(cfg: TransformerConfig, params: dict, cache, tokens: torch.Tensor,
                pos: torch.Tensor):
    """One autoregressive step: tokens [B] at position ``pos`` (an int32
    scalar tensor on the params' device) against caches [L,B,S,Hkv,dh].

    Writes each layer's new K and V row into the caches **in place** (the
    reference returns updated copies) and attends to positions ``<= pos``
    with kernel K7 on the card.  Nothing leaves the device: a decode loop can
    feed ``pos + 1`` and the argmax back without a host sync.  Returns
    ``(logits [B, Vp], (k_cache, v_cache))``, the same cache tensors."""
    if pos.dim() != 0:
        raise NotImplementedError("decode_step: pos must be a scalar (one position "
                                  "for the whole batch)")
    dt = cfg.compute_dtype
    B = tokens.shape[0]
    Hp, Hkv, dh = cfg.padded_heads(), cfg.n_kv_heads, cfg.d_head
    k_cache, v_cache = cache
    x = L.sharded_vocab_embed(params["embed"], tokens[:, None], None, out_dtype=dt)
    posb = pos.reshape(1, 1)
    cache_len = (pos + 1).to(torch.int32)
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (h @ lp["wq"].to(dt)).reshape(B, Hp, dh)
        k_new = (h @ lp["wk"].to(dt)).reshape(B, Hkv, dh)
        v_new = (h @ lp["wv"].to(dt)).reshape(B, Hkv, dh)
        if cfg.qkv_bias:
            q = q + lp["bq"].to(dt).reshape(Hp, dh)
            k_new = k_new + lp["bk"].to(dt).reshape(Hkv, dh)
            v_new = v_new + lp["bv"].to(dt).reshape(Hkv, dh)
        q = L.apply_rope(q[:, None], posb, cfg.rope_theta)[:, 0]
        k_new = L.apply_rope(k_new[:, None], posb, cfg.rope_theta)[:, 0]
        k_c = L.kv_cache_update_shard(k_cache[li], k_new, pos)
        v_c = L.kv_cache_update_shard(v_cache[li], v_new, pos)
        attn = L.flash_decode_shard(q, k_c, v_c, cache_len)
        x = x + attn.reshape(B, 1, Hp * dh) @ lp["wo"].to(dt)
        x = x + _ffn(cfg, lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x[:, 0] @ params["head"].to(dt).T, (k_cache, v_cache)
