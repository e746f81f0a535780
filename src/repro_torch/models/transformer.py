"""Decoder-only LM family (dense GQA and MoE variants): the serving path.

Port of ``repro/models/transformer.py``'s serving path: ``forward`` and
``prefill`` (a whole prompt on one device; attention is kernel K6 on the
card) and ``decode_step`` (one token against the KV cache; attention is
kernel K7), with the experts of ``cfg.moe`` (``models/moe.py``) beside or
instead of the dense SwiGLU FFN.  Parameters are a nested dict of tensors
with the reference's keys and its ``[L, ...]``-stacked layer layout, so
``params_from_numpy`` carries the reference's weights across unchanged,
experts included.  The layers run as a Python loop (no scan, no remat:
serving keeps no activations for a backward pass).

Under a ``launch.mesh.Mesh``, ``decode_step`` is the reference's
sequence-sharded decode: each rank holds its block of the KV caches (batch
over ``batch_axes``, positions over ``seq_axes``: ``cache_specs``) and of
the params (``decode_param_specs``: the token table and the LM head by rows
over `model`, the experts over `model`); attention is K7's shard mode and
the flash-decoding combine over ``seq_axes``, the token embedding the
all-reduced lookup of ``layers.sharded_vocab_embed``, the experts the
all-reduced partials of ``_moe_forward``, and the head gives the rank's
vocab block of the logits.  The rest of the layer runs whole on every rank:
the reference's GSPMD computes the same values with tensor-parallel
weights.  The geometry methods of ``TransformerConfig`` take the mesh
(heads and vocab padded to the `model` axis); without one, tp is 1.

Waiting for the LM training slice (ROADMAP queue 1, item 4): ``lm_loss``,
``make_train_step``, ``abstract_params``, ``param_specs``, tensor and
sequence parallelism of ``forward``/``prefill`` under a mesh, and the
reference's remat, microbatch, FSDP and ``seq_shard`` fields.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.sharding import AXIS_DATA, AXIS_MODEL, PartitionSpec
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.utils import numpy_to_tensor, resolve_device, round_up, tree_map


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config cut to the fields the serving path reads; the
    training fields (remat, microbatches, FSDP, sequence parallelism) come
    back with the LM training slice."""

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
    moe: MOE.MoEConfig | None = None
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    # ---- mesh-dependent geometry (a launch.mesh.Mesh or AbstractMesh) ----
    def tp(self, mesh=None) -> int:
        """The tensor-parallel degree: the `model` axis, 1 without a mesh."""
        return mesh.shape[AXIS_MODEL] if mesh is not None else 1

    def padded_heads(self, mesh=None) -> int:
        """Heads padded up to a multiple of tp (arctic's 56 -> 64 on 16)."""
        return round_up(self.n_heads, self.tp(mesh))

    def kv_sharded(self, mesh=None) -> bool:
        return self.n_kv_heads % self.tp(mesh) == 0

    def padded_vocab(self, mesh=None) -> int:
        return round_up(self.vocab, 128 * self.tp(mesh))

    def dense_ffn(self) -> bool:
        """Whether the layers have the dense SwiGLU FFN (no experts, or
        experts with the dense residual)."""
        return self.moe is None or self.moe_dense_residual

    def num_params(self, mesh=None) -> int:
        D, F, Vp = self.d_model, self.d_ff, self.padded_vocab(mesh)
        Hd = self.padded_heads(mesh) * self.d_head
        Kd = self.n_kv_heads * self.d_head
        per_layer = D * Hd + 2 * D * Kd + Hd * D + 2 * D
        if self.dense_ffn():
            per_layer += 3 * D * F
        if self.moe is not None:
            per_layer += D * self.moe.num_experts + 3 * self.moe.num_experts * D * self.moe.d_ff
        return self.n_layers * per_layer + 2 * Vp * D + D


# ------------------------------------------------------------------ params


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda", mesh=None) -> dict:
    """Random parameters with the reference's shapes, dtypes and scales
    (normal / sqrt(fan_in), the router and the padded heads' ``wo`` rows
    included; the embedding normal * 0.02; norms 1; biases 0), whole, with
    heads and vocab padded for ``mesh`` (a ``Mesh`` or ``AbstractMesh``),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``
    (raises when ``device`` is CUDA and no GPU is present).  The numbers
    differ from the reference's ``jax.random``; parity tests carry the
    reference's weights across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, dh, Hp, Hkv = cfg.d_model, cfg.d_head, cfg.padded_heads(mesh), cfg.n_kv_heads
    Lyr, Vp, dt = cfg.n_layers, cfg.padded_vocab(mesh), cfg.param_dtype

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
    if cfg.dense_ffn():
        lyr["wg"] = nrm((Lyr, D, cfg.d_ff), D)
        lyr["wu"] = nrm((Lyr, D, cfg.d_ff), D)
        lyr["wd"] = nrm((Lyr, cfg.d_ff, D), cfg.d_ff)
    if cfg.moe is not None:
        E, F = cfg.moe.num_experts, cfg.moe.d_ff
        lyr["router"] = nrm((Lyr, D, E), D)
        lyr["xg"] = nrm((Lyr, E, D, F), D)
        lyr["xu"] = nrm((Lyr, E, D, F), D)
        lyr["xd"] = nrm((Lyr, E, F, D), F)
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


def decode_param_specs(cfg: TransformerConfig) -> dict:
    """The layout ``decode_step`` takes its params in under a mesh: the
    token table and the LM head by rows over `model` (the reference's), the
    experts over `model` (the reference's expert parallelism), the rest
    whole on every rank."""
    keys = ["ln1", "ln2", "wq", "wk", "wv", "wo"]
    keys += ["bq", "bk", "bv"] if cfg.qkv_bias else []
    keys += ["wg", "wu", "wd"] if cfg.dense_ffn() else []
    lyr = {k: PartitionSpec() for k in keys}
    if cfg.moe is not None:
        lyr["router"] = PartitionSpec()
        lyr.update({k: PartitionSpec(None, AXIS_MODEL) for k in ("xg", "xu", "xd")})
    return {"embed": PartitionSpec(AXIS_MODEL, None), "layers": lyr,
            "final_ln": PartitionSpec(), "head": PartitionSpec(AXIS_MODEL, None)}


# ------------------------------------------------------------------ forward


def _dense_ffn(cfg: TransformerConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    g = torch.nn.functional.silu(h @ lp["wg"].to(dt)) * (h @ lp["wu"].to(dt))
    return g @ lp["wd"].to(dt)


def _moe_forward(cfg: TransformerConfig, lp: dict, h: torch.Tensor, mesh=None,
                 batch_axes: tuple[str, ...] = (AXIS_DATA,), with_aux: bool = True):
    """Expert layer over h [B,S,D] -> (out [B,S,D], aux or None).  Under a
    mesh the rank holds ``E / tp`` experts over `model` and its batch block
    of h (replicated over `model`): local dispatch, then an all-reduce of
    the partial over `model` (the hierarchical-pooling pattern, see
    models/moe.py); aux, each block's Switch loss, is averaged over
    ``batch_axes`` (GShard practice), and skipped without ``with_aux``."""
    B, S, D = h.shape
    params = {"router": lp["router"], "w_gate": lp["xg"], "w_up": lp["xu"],
              "w_down": lp["xd"]}
    if mesh is None:
        out, aux = MOE.moe_apply_local(params, h.reshape(B * S, D), cfg.moe, 1, None)
        return out.reshape(B, S, D), aux if with_aux else None
    partial, aux = MOE.moe_apply_local(params, h.reshape(B * S, D), cfg.moe,
                                       mesh.shape[AXIS_MODEL], mesh.coords[AXIS_MODEL])
    out = M.all_reduce(partial, (AXIS_MODEL,), mesh).reshape(B, S, D)
    if not with_aux:
        return out, None
    if batch_axes:
        aux = M.all_reduce(aux, batch_axes, mesh) / mesh.axis_size(batch_axes)
    return out, aux


def _ffn(cfg: TransformerConfig, lp: dict, h: torch.Tensor, mesh=None,
         batch_axes: tuple[str, ...] = (AXIS_DATA,), with_aux: bool = True):
    """The layer's FFN on the normed h: the dense SwiGLU, the experts, or
    both summed (``moe_dense_residual``), as the reference adds them to a
    zero; and the experts' aux loss (None without experts or ``with_aux``)."""
    out, aux = None, None
    if cfg.dense_ffn():
        out = _dense_ffn(cfg, lp, h)
    if cfg.moe is not None:
        moe_out, aux = _moe_forward(cfg, lp, h, mesh, batch_axes, with_aux)
        out = moe_out if out is None else out + moe_out
    return out, aux


def _layer_forward(cfg: TransformerConfig, x: torch.Tensor, lp: dict,
                   positions: torch.Tensor):
    """One transformer block over a whole sequence. x: [B,S,D] -> (x, k, v,
    aux)."""
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
    ffn, aux = _ffn(cfg, lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x + ffn, k, v, aux


def _hidden(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            return_cache: bool):
    """Final-normed hidden states [B,S,D], the experts' aux loss summed
    over the layers and, if asked, the KV caches [L,B,S,Hkv,dh] in the
    compute dtype."""
    dt = cfg.compute_dtype
    B, S = tokens.shape
    x = L.sharded_vocab_embed(params["embed"], tokens, None, out_dtype=dt)
    positions = torch.arange(S, device=tokens.device)[None, :]
    caches = None
    if return_cache:
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
        caches = (torch.empty(shape, dtype=dt, device=tokens.device),
                  torch.empty(shape, dtype=dt, device=tokens.device))
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for li in range(cfg.n_layers):
        x, k, v, aux_l = _layer_forward(cfg, x, layer_params(params, li), positions)
        if aux_l is not None:
            aux = aux + aux_l
        if caches is not None:
            caches[0][li] = k
            caches[1][li] = v
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps), aux, caches


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            return_cache: bool = False):
    """Full-sequence forward over tokens [B, S] on the params' device.
    Returns ``(logits [B,S,Vp], aux_loss)`` and, with ``return_cache``, the
    KV caches ``(k_cache, v_cache)`` [L,B,S,Hkv,dh] as a third element.
    ``aux_loss`` is the experts' Switch loss summed over the layers (0
    without experts)."""
    x, aux, caches = _hidden(cfg, params, tokens, return_cache)
    logits = x @ params["head"].to(cfg.compute_dtype).T
    return (logits, aux, caches) if return_cache else (logits, aux)


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """Prefill: last-position logits [B, Vp] and the KV caches
    [L,B,S,Hkv,dh].  Only the last position goes through the LM head (the
    reference computes every position's logits and keeps the last)."""
    x, _, caches = _hidden(cfg, params, tokens, return_cache=True)
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


def cache_specs(cfg: TransformerConfig, batch_axes: tuple[str, ...],
                seq_axes: tuple[str, ...]) -> PartitionSpec:
    """The layout of the [L, B, S, Hkv, dh] caches under ``decode_step``'s
    mesh: batch over ``batch_axes``, positions over ``seq_axes``."""
    return PartitionSpec(None, tuple(batch_axes) or None, tuple(seq_axes) or None, None, None)


def decode_step(cfg: TransformerConfig, params: dict, cache, tokens: torch.Tensor,
                pos: torch.Tensor, mesh=None, batch_axes: tuple[str, ...] = (AXIS_DATA,),
                seq_axes: tuple[str, ...] = (AXIS_MODEL,)):
    """One autoregressive step: tokens [B] at position ``pos`` (an int32
    scalar tensor on the params' device) against caches [L,B,S,Hkv,dh].

    Writes each layer's new K and V row into the caches **in place** (the
    reference returns updated copies) and attends to positions ``<= pos``
    with kernel K7 on the card.  Nothing leaves the device: a decode loop can
    feed ``pos + 1`` and the argmax back without a host sync.  Returns
    ``(logits [B, Vp], (k_cache, v_cache))``, the same cache tensors.

    Under ``mesh`` every argument is this rank's block: tokens of its batch
    block (``batch_axes``), the caches by ``cache_specs(cfg, batch_axes,
    seq_axes)``, the params by ``decode_param_specs(cfg)`` with heads and
    vocab padded for the mesh; the logits are its [B_l, Vp / tp] block of
    the reference's ``P(batch_axes, model)``.  Every rank writes the new rows
    into its shard only (position ``pos`` lives on one), attends over its
    shard with K7's shard mode and combines over ``seq_axes``.  With
    ``batch_axes=()`` and ``seq_axes`` every axis this is the long_500k
    layout (B = 1)."""
    if pos.dim() != 0:
        raise NotImplementedError("decode_step: pos must be a scalar (one position "
                                  "for the whole batch)")
    dt = cfg.compute_dtype
    B = tokens.shape[0]
    Hp, Hkv, dh = cfg.padded_heads(mesh), cfg.n_kv_heads, cfg.d_head
    k_cache, v_cache = cache
    x = L.sharded_vocab_embed(params["embed"], tokens[:, None], mesh, out_dtype=dt)
    posb = pos.reshape(1, 1)
    cache_len = (pos + 1).to(torch.int32)
    start, combine = 0, ()
    if mesh is not None and seq_axes:
        combine = tuple(seq_axes)
        start = torch.full((), mesh.index(combine) * k_cache.shape[2], dtype=torch.int32,
                           device=pos.device)
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
        k_c = L.kv_cache_update_shard(k_cache[li], k_new, pos, start)
        v_c = L.kv_cache_update_shard(v_cache[li], v_new, pos, start)
        attn = L.flash_decode_shard(q, k_c, v_c, cache_len, start, combine, mesh)
        x = x + attn.reshape(B, 1, Hp * dh) @ lp["wo"].to(dt)
        ffn, _ = _ffn(cfg, lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), mesh, batch_axes,
                      with_aux=False)
        x = x + ffn
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x[:, 0] @ params["head"].to(dt).T, (k_cache, v_cache)
