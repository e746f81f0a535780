"""Decoder-only LM family (dense GQA and MoE variants): serving and
training.

Port of ``repro/models/transformer.py``: ``forward`` and ``prefill`` (a
whole prompt on one device; attention is kernel K6 on the card),
``decode_step`` (one token against the KV cache; attention is kernel K7),
and training: ``lm_loss`` and ``make_train_step`` (gradient accumulation
over ``cfg.microbatches``, ``cfg.bf16_grads``), whose ``forward`` runs the
reference's two-level remat and whose attention backward is kernel K6' on
the card.  The experts of ``cfg.moe`` (``models/moe.py``) run beside or
instead of the dense SwiGLU FFN.  Parameters are a nested dict of tensors
with the reference's keys and its ``[L, ...]``-stacked layer layout, so
``params_from_numpy`` carries the reference's weights across unchanged,
experts included; ``abstract_params`` gives them as ``meta`` tensors and
``param_specs`` the reference's GSPMD layout of them.  The layers run as a
Python loop; under autograd they run inside ``torch.utils.checkpoint``
(non-reentrant) around groups of ``cfg.groups()`` and again around each
layer, as the reference's ``jax.checkpoint`` around its two scans: the
backward of a group recomputes its layers' inputs, then each layer's
internals, one layer at a time.

Under a ``launch.mesh.Mesh`` ``forward``, ``prefill``, ``loss_and_grads``
and ``make_train_step`` run the reference's GSPMD tensor, sequence and FSDP
parallelism with its collectives made explicit (``layers.into_model``,
``out_of_model``, ``fsdp_gather``, ``vocab_parallel_nll``): each rank holds
its batch block over ``batch_axes``, its `model` block of the query heads
(K6 on them), the KV heads where they divide tp, the FFN columns, the
experts and the vocab, and of the residual stream's sequence under
``cfg.seq_shard``; weight rows split over ``batch_axes`` under ``cfg.fsdp``
are all-gathered at use (``mesh_param_specs``).  Each rank's gradient is
its block of the global gradient in its param's layout; ``prefill``'s
caches go on to ``decode_step`` through ``caches_for_decode``.

``decode_step`` is the reference's sequence-sharded decode, in the same
param layout: each rank holds its block of the KV caches (batch over
``batch_axes``, positions over ``seq_axes``: ``cache_specs``); it computes
its `model` block of the query heads (and of the KV heads where they
divide tp) and all-gathers them over `model`, so that attention is K7's
shard mode on its sequence shard and the flash-decoding combine over
``seq_axes``; its ``wo`` and ``wd`` rows and its experts give partials
summed over `model`; the token embedding is the all-reduced lookup of
``layers.sharded_vocab_embed`` and the head gives the rank's vocab block
of the logits.  Under FSDP it follows the reference's compiled program:
with the batch over the FSDP axes the weights are gathered at use, with
no batch axes (long_500k) the residual's model dim stays split over them
and the partial products are all-reduced there (``_decode_parallel``).
The geometry methods of ``TransformerConfig`` take the mesh (heads and
vocab padded to the `model` axis); without one, tp is 1.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core.sharding import AXIS_DATA, AXIS_MODEL, AXIS_POD, PartitionSpec, is_spec
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.utils import (numpy_to_tensor, resolve_device, round_up, tree_flatten_with_path,
                               tree_map, tree_unflatten)

P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, every field with its default.  ``q_block``
    (the reference's remat block of queries in its jnp attention) has no
    effect here: K6 and its plain version tile themselves.  ``seq_shard``
    and ``fsdp`` are layouts under a mesh (``mesh_param_specs``)."""

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
    q_block: int = 512
    seq_shard: bool = False  # sequence-parallel residual stream
    remat_groups: int = 0  # 0 -> auto (~sqrt(L))
    fsdp: bool = True  # shard weight rows over `data` too
    microbatches: int = 1  # gradient-accumulation splits of the per-step batch
    # Differentiate through a copy of the weights in the compute dtype (cast
    # once per step); the f32 master lives only in the optimizer.
    bf16_grads: bool = False

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

    def groups(self) -> int:
        """Remat groups: ``remat_groups``, or the largest divisor of the
        layer count at most sqrt(L)."""
        if self.remat_groups:
            return self.remat_groups
        g = max(1, int(math.sqrt(self.n_layers)))
        while self.n_layers % g:
            g -= 1
        return g

    def batch_axes(self, multi_pod: bool) -> tuple[str, ...]:
        return (AXIS_POD, AXIS_DATA) if multi_pod else (AXIS_DATA,)

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
    # meta tensors (abstract_params) hold no numbers and take no generator
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
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


def abstract_params(cfg: TransformerConfig, mesh=None) -> dict:
    """The params' global shapes and dtypes as ``meta`` tensors (the
    reference's ``jax.eval_shape`` of its init): no allocation."""
    return init_params(cfg, 0, device="meta", mesh=mesh)


def param_specs(cfg: TransformerConfig, mesh, training: bool = True,
                fsdp_axes: tuple[str, ...] = (AXIS_DATA,)) -> dict:
    """The reference's PartitionSpecs of every parameter (its GSPMD layout):
    tensor parallelism over `model` (columns of wq/wk/wv/wg/wu, rows of
    wo/wd, experts), weight rows also over ``fsdp_axes`` when training with
    ``cfg.fsdp``, KV columns over `model` only where the KV heads divide tp,
    the token table and the head by rows over `model`."""
    fsdp = fsdp_axes if (cfg.fsdp and training) else None
    kv_col = AXIS_MODEL if cfg.kv_sharded(mesh) else None
    lyr = {
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, fsdp, AXIS_MODEL),
        "wk": P(None, fsdp, kv_col),
        "wv": P(None, fsdp, kv_col),
        "wo": P(None, AXIS_MODEL, fsdp),
    }
    if cfg.qkv_bias:
        lyr["bq"] = P(None, AXIS_MODEL)
        lyr["bk"] = P(None, kv_col)
        lyr["bv"] = P(None, kv_col)
    if cfg.dense_ffn():
        lyr["wg"] = P(None, fsdp, AXIS_MODEL)
        lyr["wu"] = P(None, fsdp, AXIS_MODEL)
        lyr["wd"] = P(None, AXIS_MODEL, fsdp)
    if cfg.moe is not None:
        lyr["router"] = P(None, None, None)
        lyr["xg"] = P(None, AXIS_MODEL, fsdp, None)
        lyr["xu"] = P(None, AXIS_MODEL, fsdp, None)
        lyr["xd"] = P(None, AXIS_MODEL, None, fsdp)
    return {"embed": P(AXIS_MODEL, None), "layers": lyr, "final_ln": P(None),
            "head": P(AXIS_MODEL, None)}


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


@dataclasses.dataclass(frozen=True)
class _Parallel:
    """How a rank runs the layers: with no mesh, whole (every method the
    identity); under one, the reference's GSPMD layout made explicit.  The
    rank holds its batch block over ``batch_axes``, its `model` block of
    the heads, the FFN columns and the experts, and of the sequence of the
    residual stream under ``seq_shard``; the weights' rows are split over
    ``fsdp_axes`` (``cfg.fsdp``) and gathered at use: ``fsdp_dims`` holds
    the dim that ``mesh_param_specs`` splits over them in one layer's
    slice of each such weight."""

    mesh: Any = None
    batch_axes: tuple[str, ...] = ()
    fsdp_axes: tuple[str, ...] = ()
    seq_shard: bool = False
    fsdp_dims: dict = dataclasses.field(default_factory=dict)

    def into(self, h: torch.Tensor) -> torch.Tensor:
        return L.into_model(h, self.mesh, self.seq_shard)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return L.out_of_model(y, self.mesh, self.seq_shard)

    def weight(self, lp: dict, name: str) -> torch.Tensor:
        if name not in self.fsdp_dims:
            return lp[name]
        return L.fsdp_gather(lp[name], self.fsdp_axes, self.mesh, self.fsdp_dims[name])


ONE_DEVICE = _Parallel()


def _parallel(cfg: TransformerConfig, mesh, batch_axes, fsdp_axes=None) -> _Parallel:
    """The rank's ``_Parallel``: weight rows split over ``fsdp_axes``
    (default ``batch_axes``) where ``cfg.fsdp``."""
    if mesh is None:
        return ONE_DEVICE
    batch_axes = tuple(batch_axes)
    fsdp_axes = batch_axes if fsdp_axes is None else tuple(fsdp_axes)
    if not (cfg.fsdp and fsdp_axes):
        return _Parallel(mesh, batch_axes, (), cfg.seq_shard)
    lyr = mesh_param_specs(cfg, mesh, fsdp_axes)["layers"]
    dims = {name: d - 1 for name, spec in lyr.items() for d in range(1, len(spec))
            if spec.axes_of(d) == fsdp_axes}
    return _Parallel(mesh, batch_axes, fsdp_axes, cfg.seq_shard, dims)


def mesh_param_specs(cfg: TransformerConfig, mesh,
                     batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> dict:
    """The layout ``forward``, ``prefill`` and the train step take their
    params in under a mesh: ``param_specs`` with the weights' rows over
    ``batch_axes`` when ``cfg.fsdp`` (the train cell's, and the serving
    cells', whose config sets ``fsdp`` to ``fsdp_serve``)."""
    return param_specs(cfg, mesh, training=True, fsdp_axes=tuple(batch_axes) or None)


def _dense_ffn(cfg: TransformerConfig, lp: dict, h: torch.Tensor,
               par: _Parallel = ONE_DEVICE) -> torch.Tensor:
    """The SwiGLU FFN over h; under a mesh the rank's partial (its `model`
    columns of wg/wu and rows of wd)."""
    dt = cfg.compute_dtype
    g = torch.nn.functional.silu(h @ par.weight(lp, "wg").to(dt)) \
        * (h @ par.weight(lp, "wu").to(dt))
    return g @ par.weight(lp, "wd").to(dt)


def _moe_partial(cfg: TransformerConfig, lp: dict, h: torch.Tensor,
                 par: _Parallel = ONE_DEVICE):
    """The experts over h [B,S,D]: ``(out [B,S,D], aux)``, where under a
    mesh ``out`` is this rank's partial (its ``E / tp`` experts of `model`;
    the caller sums the partials over `model`) and ``aux`` its batch
    block's Switch loss."""
    B, S, D = h.shape
    params = {"router": lp["router"], "w_gate": par.weight(lp, "xg"),
              "w_up": par.weight(lp, "xu"), "w_down": par.weight(lp, "xd")}
    shards, shard = (1, None) if par.mesh is None else (par.mesh.shape[AXIS_MODEL],
                                                        par.mesh.coords[AXIS_MODEL])
    out, aux = MOE.moe_apply_local(params, h.reshape(B * S, D), cfg.moe, shards, shard)
    return out.reshape(B, S, D), aux


def _kv_for_heads(cfg: TransformerConfig, mesh, k: torch.Tensor) -> torch.Tensor:
    """The KV heads [B,S,*,dh] that this rank's query heads read.  KV
    sharded over `model` (or no mesh): ``k`` itself, whose heads serve the
    rank's query heads in groups as on one device.  Otherwise the rank
    computed every KV head: query head h of the padded ``Hp`` reads KV head
    ``h // (Hp / Hkv)`` (the reference's repeat to ``Hp`` heads), so it
    takes the range its heads read, in groups where they form them, else
    one KV head a query head."""
    if mesh is None or cfg.kv_sharded(mesh):
        return k
    hp, hkv = cfg.padded_heads(mesh), cfg.n_kv_heads
    if hp % hkv:
        raise ValueError(f"{cfg.name}: {hp} padded heads do not group over {hkv} KV heads")
    g, hl = hp // hkv, hp // cfg.tp(mesh)
    first = mesh.coords[AXIS_MODEL] * hl
    used = [(first + j) // g for j in range(hl)]
    lo, n = used[0], used[-1] - used[0] + 1
    if hl % n == 0 and used == [lo + j // (hl // n) for j in range(hl)]:
        return k[:, :, lo:lo + n]
    return k[:, :, used]


def _layer_forward(cfg: TransformerConfig, x: torch.Tensor, lp: dict,
                   positions: torch.Tensor, par: _Parallel = ONE_DEVICE):
    """One transformer block over a whole sequence. x: [B,S,D] -> (x, k, v,
    aux).  Under a mesh (``par``) x is the rank's block of the residual
    stream and each rank computes its ``Hp / tp`` query heads (attention is
    K6 on them), its KV heads (``_kv_for_heads``) and its FFN columns and
    experts; k and v are its block of the caches' ``kv_spec`` layout and aux
    its batch block's Switch loss."""
    dt = cfg.compute_dtype
    dh, mesh = cfg.d_head, par.mesh
    h = par.into(L.rms_norm(x, lp["ln1"], cfg.norm_eps))
    B, S, _ = h.shape
    q = h @ par.weight(lp, "wq").to(dt)
    k = h @ par.weight(lp, "wk").to(dt)
    v = h @ par.weight(lp, "wv").to(dt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    q = L.apply_rope(q.reshape(B, S, -1, dh), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, -1, dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, -1, dh)
    # GQA by index inside the attention (the reference repeats KV to the
    # padded head count for its 16-way mesh; the math is the same).
    attn = L.gqa_prefill_attention(q, _kv_for_heads(cfg, mesh, k),
                                   _kv_for_heads(cfg, mesh, v), causal=True)
    x = x + par.out(attn.reshape(B, S, -1) @ par.weight(lp, "wo").to(dt))
    h = par.into(L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    ffn, aux = None, None
    if cfg.dense_ffn():
        ffn = _dense_ffn(cfg, lp, h, par)
    if cfg.moe is not None:
        moe_out, aux = _moe_partial(cfg, lp, h, par)
        ffn = moe_out if ffn is None else ffn + moe_out
    return x + par.out(ffn), k, v, aux


def _remat_layers(cfg: TransformerConfig, layers: dict, x: torch.Tensor,
                  positions: torch.Tensor, par: _Parallel = ONE_DEVICE):
    """The layers under the reference's two-level remat: a non-reentrant
    ``torch.utils.checkpoint`` around each group of ``L / cfg.groups()``
    layers, which keeps only the group's input, and inside it one around
    each layer, which keeps only the layer's input; so a group's backward
    recomputes its layers' inputs and then one layer's internals at a time
    (under a mesh the collectives too: every rank recomputes the same
    layers in the same order).  Returns the last hidden state and the
    summed aux loss."""
    G = cfg.groups()
    per = cfg.n_layers // G
    if per * G != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {G} remat groups do not divide {cfg.n_layers} layers")
    # One view a layer of each stacked weight: unbind's backward stacks the L
    # gradients once (indexing would add L zero-filled [L, ...] tensors).
    names = list(layers)
    per_layer = [dict(zip(names, ts)) for ts in zip(*(layers[n].unbind(0) for n in names))]
    ckpt = functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False)

    def one_layer(x, aux, lp):
        x, _, _, aux_l = _layer_forward(cfg, x, lp, positions, par)
        return x, aux if aux_l is None else aux + aux_l

    def one_group(x, aux, g):
        for lp in per_layer[g * per:(g + 1) * per]:
            x, aux = ckpt(one_layer, x, aux, lp)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(G):
        x, aux = ckpt(one_group, x, aux, g)
    return x, aux


def _global_aux(cfg: TransformerConfig, aux: torch.Tensor, par: _Parallel) -> torch.Tensor:
    """The rank's summed Switch losses as the reference's aux: the mean of
    the batch blocks' (GShard practice).  The `model` ranks of a block hold
    the same value, so the mean is taken over every rank: each then takes
    one share of its cotangent, which the all-reduce of ``into`` sums."""
    if par.mesh is None or cfg.moe is None:
        return aux
    axes = par.mesh.axis_names
    return M.reduce_from(aux, axes, par.mesh) / par.mesh.axis_size(axes)


def _hidden(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            return_cache: bool, remat: bool = False, par: _Parallel = ONE_DEVICE):
    """Final-normed hidden states [B,S,D], the experts' aux loss summed
    over the layers and, if asked, the KV caches [L,B,S,Hkv,dh] in the
    compute dtype; with ``remat`` the layers run under
    :func:`_remat_layers` (no caches).  Under a mesh (``par``) tokens are
    the rank's batch block, the hidden states its block of the residual
    stream (the sequence split over `model` under ``seq_shard``), the
    caches its block of ``kv_spec`` and the aux its batch block's."""
    dt = cfg.compute_dtype
    B, S = tokens.shape
    if par.seq_shard and S % cfg.tp(par.mesh):
        raise ValueError(f"seq_shard: {S} positions do not split over {cfg.tp(par.mesh)} ranks")
    x = L.sharded_vocab_embed(params["embed"], tokens, par.mesh, out_dtype=dt,
                              scatter_dim=1 if par.seq_shard else None)
    positions = torch.arange(S, device=tokens.device)[None, :]
    if remat:
        if return_cache:
            raise ValueError("remat keeps no caches")
        x, aux = _remat_layers(cfg, params["layers"], x, positions, par)
        return L.rms_norm(x, params["final_ln"], cfg.norm_eps), aux, None
    caches = None
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for li in range(cfg.n_layers):
        x, k, v, aux_l = _layer_forward(cfg, x, layer_params(params, li), positions, par)
        if aux_l is not None:
            aux = aux + aux_l
        if return_cache:
            if caches is None:
                caches = tuple(torch.empty((cfg.n_layers,) + t.shape, dtype=dt,
                                           device=tokens.device) for t in (k, v))
            caches[0][li] = k
            caches[1][li] = v
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps), aux, caches


def _needs_grad(params: dict) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for _, t in tree_flatten_with_path(params))


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, mesh=None,
            batch_axes: tuple[str, ...] = (AXIS_DATA,), return_cache: bool = False):
    """Full-sequence forward over tokens [B, S] on the params' device.
    Returns ``(logits [B,S,Vp], aux_loss)`` and, with ``return_cache``, the
    KV caches ``(k_cache, v_cache)`` [L,B,S,Hkv,dh] as a third element.
    ``aux_loss`` is the experts' Switch loss summed over the layers (0
    without experts).  Whenever autograd will differentiate the params and
    no caches are asked for, the layers run under the reference's two-level
    remat; it changes no value.

    Under a ``launch.mesh.Mesh`` every argument and result is this rank's
    block: tokens of its batch block over ``batch_axes``, the params laid
    out by ``mesh_param_specs(cfg, mesh, batch_axes)`` (heads and vocab
    padded for the mesh), the logits its ``[B_l, S, Vp / tp]`` block of the
    reference's ``P(batch_axes, None, model)``, the caches its block of
    ``P(None, batch_axes, None, model or None, None)`` (KV heads over
    `model` where they divide tp), and aux the reference's mean of the
    batch blocks' Switch losses."""
    par = _parallel(cfg, mesh, batch_axes)
    remat = not return_cache and _needs_grad(params)
    x, aux, caches = _hidden(cfg, params, tokens, return_cache, remat, par)
    aux = _global_aux(cfg, aux, par)
    logits = par.into(x) @ params["head"].to(cfg.compute_dtype).T
    return (logits, aux, caches) if return_cache else (logits, aux)


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor, mesh=None,
            batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """Prefill: last-position logits [B, Vp] and the KV caches
    [L,B,S,Hkv,dh].  Only the last position goes through the LM head (the
    reference computes every position's logits and keeps the last).  Under
    a mesh, blocks as in :func:`forward`: the logits' ``[B_l, Vp / tp]``
    and the caches' ``kv_spec`` blocks, which ``caches_for_decode`` turns
    into ``decode_step``'s."""
    par = _parallel(cfg, mesh, batch_axes)
    x, _, caches = _hidden(cfg, params, tokens, True, par=par)
    last = x[:, -1]
    if par.seq_shard:  # the last position lives on the last `model` rank
        last = M.all_gather(x[:, -1:], (AXIS_MODEL,), mesh, dim=1)[:, -1]
    return last @ params["head"].to(cfg.compute_dtype).T, caches


@torch.no_grad()
def caches_for_decode(cfg: TransformerConfig, caches, max_len: int, mesh,
                      batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """``prefill``'s caches under a mesh (this rank's block of its
    ``kv_spec`` layout: batch over ``batch_axes``, KV heads over `model`
    where they divide tp) as ``decode_step``'s: every KV head, positions
    padded with zeros to ``max_len`` and this rank's block of
    ``cache_specs(cfg, batch_axes, (model,))``, the batch kept where
    prefill split it and the positions over `model`.  The reference's jit
    reshards them implicitly; here the KV heads are all-gathered over
    `model`.  New tensors: decode writes them in place."""
    n_seq = mesh.shape[AXIS_MODEL]
    if max_len % n_seq:
        raise ValueError(f"caches_for_decode: {max_len} positions do not split over "
                         f"{n_seq} ranks of {AXIS_MODEL}")
    s_loc = max_len // n_seq
    start = mesh.coords[AXIS_MODEL] * s_loc
    out = []
    for c in caches:
        if c.shape[2] > max_len:
            raise ValueError(f"caches_for_decode: {c.shape[2]} prompt positions past "
                             f"max_len {max_len}")
        if cfg.kv_sharded(mesh) and cfg.tp(mesh) > 1:
            c = M.all_gather(c, (AXIS_MODEL,), mesh, dim=3)
        block = torch.zeros(c.shape[:2] + (s_loc,) + c.shape[3:], dtype=c.dtype,
                            device=c.device)
        n = max(0, min(c.shape[2] - start, s_loc))
        block[:, :, :n] = c[:, :, start:start + n]
        out.append(block)
    return tuple(out)


# ------------------------------------------------------------------ training


def lm_loss(cfg: TransformerConfig, logits: torch.Tensor, labels: torch.Tensor, mesh=None,
            batch_axes: tuple[str, ...] = (AXIS_DATA,)) -> torch.Tensor:
    """Causal-LM cross entropy in f32 over logits [B,S,Vp] (the padded vocab
    columns included, as the reference's); labels [B,S] with -1 masked; the
    mean over the unmasked labels (0 when none is).  Under a mesh the
    logits are the rank's ``[B_l, S, Vp / tp]`` block and the labels its
    batch block: the vocab-parallel cross entropy
    (``layers.vocab_parallel_nll``), the mean over the global batch."""
    if mesh is not None:
        return L.vocab_parallel_nll(logits, labels, mesh, tuple(batch_axes))
    logits = logits.to(torch.float32)
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = (lse - picked) * mask
    return nll.sum() / mask.sum().clamp_min(1)


def grad_sum_axes(cfg: TransformerConfig, mesh, batch_axes: tuple[str, ...],
                  name: str) -> tuple[str, ...]:
    """The mesh axes over which the ranks' gradients of leaf ``name`` (of
    the params laid out by ``mesh_param_specs``) are summed into the
    rank's block of the reference's: each rank's is its batch block's
    contribution, so every leaf sums over ``batch_axes``, but a weight
    gathered by FSDP, whose gather's backward reduce-scattered it there
    already; and over `model` the leaves whose rank holds a part of the
    contribution there: the norms on a sequence-sharded stream, the router
    (its gates see the rank's experts only, its aux one share) and the KV
    projections where KV is not sharded (the rank's heads read some KV
    heads).  A leaf split over `model` holds its whole block's gradient."""
    par = _parallel(cfg, mesh, batch_axes)
    over_model = {"router"}
    if par.seq_shard:
        over_model |= {"ln1", "ln2", "final_ln"}
    if not cfg.kv_sharded(mesh):
        over_model |= {"wk", "wv", "bk", "bv"}
    data = () if name in par.fsdp_dims else par.batch_axes
    return data + ((AXIS_MODEL,) if name in over_model else ())


def _sum_grads(cfg: TransformerConfig, params: dict, grads: list, mesh,
               batch_axes: tuple[str, ...]) -> list:
    """Each rank's gradients summed over ``grad_sum_axes``: one all-reduce
    of the leaves that share axes and dtype, concatenated."""
    groups: dict = {}
    for i, (path, g) in enumerate(zip((p for p, _ in tree_flatten_with_path(params)), grads)):
        axes = grad_sum_axes(cfg, mesh, batch_axes, path[-1])
        if axes:
            groups.setdefault((axes, g.dtype), []).append(i)
    out = list(grads)
    for (axes, _), idx in groups.items():
        flat = M.all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), axes, mesh)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def loss_and_grads(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, mesh=None,
                   batch_axes: tuple[str, ...] = (AXIS_DATA,)):
    """``(loss, grads)``: ``lm_loss`` of ``forward`` (remat on) plus the
    experts' aux loss, and its gradient with respect to every leaf of
    ``params``, shaped as ``params`` (the reference's ``jax.value_and_grad``
    of its ``loss_fn``).  On the card attention's backward is kernel K6'.
    Under a mesh the arguments are the rank's blocks, as in ``forward``;
    the loss is the global one and each gradient the rank's block of the
    global gradient, laid out as its param (``grad_sum_axes``)."""
    leaves = [leaf.detach().requires_grad_(True)
              for _, leaf in tree_flatten_with_path(params)]
    with torch.enable_grad():
        logits, aux = forward(cfg, tree_unflatten(params, leaves), tokens, mesh, batch_axes)
        loss = lm_loss(cfg, logits, labels, mesh, batch_axes) + aux
        del logits
        grads = list(torch.autograd.grad(loss, leaves))
    if mesh is not None:
        grads = _sum_grads(cfg, params, grads, mesh, tuple(batch_axes))
    return loss.detach(), tree_unflatten(params, grads)


def _microbatch_rows(tokens: torch.Tensor, labels: torch.Tensor, n: int, mesh,
                     batch_axes: tuple[str, ...]):
    """The rank's rows of the reference's ``n`` microbatches, in order: the
    reference splits the global batch into ``n`` contiguous blocks, each
    then split over ``batch_axes``, so the rank's batch block (a contiguous
    block of the global batch) holds other rows.  Tokens and labels are
    all-gathered over ``batch_axes`` and cut again."""
    out = []
    for t in (tokens, labels):
        whole = M.all_gather(t, batch_axes, mesh, dim=0)
        blocks = whole.reshape(n, whole.shape[0] // n, *whole.shape[1:])
        out.append(L.constrain(blocks, PartitionSpec(None, batch_axes), mesh).reshape(t.shape))
    return out


def make_train_step(cfg: TransformerConfig, optimizer, mesh=None,
                    batch_axes: tuple[str, ...] = (AXIS_DATA,), grad_specs=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": loss})``, the reference's: with ``cfg.bf16_grads`` the gradient
    is taken through a copy of the params of two or more dims in the compute
    dtype; with ``cfg.microbatches`` M > 1 the batch of ``tokens`` and
    ``labels`` [B, S] splits into M blocks of B / M rows, whose losses and
    gradients are summed (gradients in f32, from zeros) and divided by M;
    then ``optimizer.update``.  Nothing waits for the device.

    Under a ``mesh`` the params, the optimizer state and the batch are the
    rank's blocks (``mesh_param_specs``, its state specs, ``P(batch_axes)``);
    each gradient is the rank's block of the global one, laid out as its
    param, which is the reference's ``grad_specs`` (any other raises), and
    the optimizer updates the rank's blocks (Adafactor given the mesh and
    the specs).  Microbatch i is the rank's rows of the reference's i-th
    block of the global batch."""
    if mesh is not None and grad_specs is not None:
        want = mesh_param_specs(cfg, mesh, batch_axes)
        got, have = (tree_flatten_with_path(t, is_spec) for t in (grad_specs, want))
        if [(p, tuple(s)) for p, s in got] != [(p, tuple(s)) for p, s in have]:
            raise ValueError("make_train_step: under a mesh the gradients take the params' "
                             "layout, mesh_param_specs(cfg, mesh, batch_axes)")

    def train_step(params, opt_state, batch):
        M_ = cfg.microbatches
        diff = params
        if cfg.bf16_grads:
            diff = tree_map(lambda p: p.to(cfg.compute_dtype) if p.dim() >= 2 else p, params)
        tokens, labels = batch["tokens"], batch["labels"]
        if M_ <= 1:
            loss, grads = loss_and_grads(cfg, diff, tokens, labels, mesh, batch_axes)
        else:
            if mesh is not None and batch_axes:
                tokens, labels = _microbatch_rows(tokens, labels, M_, mesh, tuple(batch_axes))
            B = tokens.shape[0]
            toks = tokens.reshape(M_, B // M_, -1)
            labs = labels.reshape(M_, B // M_, -1)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            acc = [t for _, t in tree_flatten_with_path(grads)]
            for i in range(M_):
                loss_i, g = loss_and_grads(cfg, diff, toks[i], labs[i], mesh, batch_axes)
                for a, b in zip(acc, (t for _, t in tree_flatten_with_path(g))):
                    a.add_(b.to(a.dtype))
                loss = loss + loss_i
                del g
            loss = loss / M_
            grads = tree_map(lambda g: g.div_(M_), grads)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss}

    return train_step


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


def _decode_parallel(cfg: TransformerConfig, mesh, batch_axes, fsdp_axes) -> tuple:
    """``(par, partial)`` for ``decode_step``: the rank's ``_Parallel``, and
    whether the residual stream is split over the FSDP axes along its model
    dim.  With the batch over the FSDP axes (decode_32k) the layer weights
    are all-gathered there at use, as the reference's compiled program
    does; with FSDP and no batch axes (long_500k) no layer weight but the
    experts is gathered: each rank keeps its block of the residual's model
    dim, multiplies it by its rows of the column-parallel weights and
    all-reduces the partial products over the FSDP axes (``partial``)."""
    par = _parallel(cfg, mesh, batch_axes, fsdp_axes)
    if par.fsdp_axes and par.batch_axes and par.fsdp_axes != par.batch_axes:
        raise NotImplementedError(f"decode_step: FSDP over {par.fsdp_axes} with the batch over "
                                  f"{par.batch_axes}")
    return par, bool(par.fsdp_axes) and not par.batch_axes


def _model_block(x: torch.Tensor, par: _Parallel, partial: bool) -> torch.Tensor:
    """The rank's block of the last (model) dim of ``x`` under ``partial``,
    else ``x``."""
    if not partial:
        return x
    n = x.shape[-1] // par.mesh.axis_size(par.fsdp_axes)
    i = par.mesh.index(par.fsdp_axes)
    return x[..., i * n:(i + 1) * n]


def _decode_norm(x: torch.Tensor, w: torch.Tensor, eps: float, par: _Parallel,
                 partial: bool) -> torch.Tensor:
    """``rms_norm``; under ``partial`` of the rank's block of the model dim,
    its sum of squares all-reduced over the FSDP axes."""
    if not partial:
        return L.rms_norm(x, w, eps)
    xf = x.to(torch.float32)
    ss = M.all_reduce((xf * xf).sum(-1, keepdim=True), par.fsdp_axes, par.mesh)
    var = ss / (x.shape[-1] * par.mesh.axis_size(par.fsdp_axes))
    w = _model_block(w, par, partial).to(torch.float32)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _decode_matmul(a: torch.Tensor, lp: dict, name: str, dt, par: _Parallel,
                   partial: bool) -> torch.Tensor:
    """``a`` times the rank's block of layer weight ``name``: gathered over
    the FSDP axes at use, or under ``partial`` the rank's rows, whose
    partial products (the rows of the model dim) are all-reduced over them;
    a weight split there along its output dim gives the rank's block of
    it."""
    if not partial:
        return a @ par.weight(lp, name).to(dt)
    y = a @ lp[name].to(dt)
    if par.fsdp_dims.get(name) == 0:
        y = M.reduce_from(y, par.fsdp_axes, par.mesh)
    return y


def _decode_layer(cfg: TransformerConfig, lp: dict, x: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: torch.Tensor, cache_len: torch.Tensor, start,
                  combine: tuple, par: _Parallel, partial: bool) -> torch.Tensor:
    """One layer of ``decode_step`` on x [B, 1, D] (under ``partial`` the
    rank's block of D): writes the new K/V row into the layer's caches in
    place and returns the new residual.  Under a mesh the rank computes its
    `model` block of the query heads (and of the KV heads where they divide
    tp, else every KV head), all-gathers them over `model` for K7's shard
    mode on its sequence shard, multiplies its block of the heads' output
    by its ``wo`` rows and its SwiGLU columns by its ``wd`` rows, and sums
    both partials over `model`; the experts run as ``_moe_partial`` on the
    whole normed state, their partial summed over `model`."""
    dt, dh, mesh = cfg.compute_dtype, cfg.d_head, par.mesh
    B = x.shape[0]
    mm = functools.partial(_decode_matmul, lp=lp, dt=dt, par=par, partial=partial)
    h = _decode_norm(x, lp["ln1"], cfg.norm_eps, par, partial)
    q = mm(h, name="wq").reshape(B, -1, dh)
    k_new = mm(h, name="wk").reshape(B, -1, dh)
    v_new = mm(h, name="wv").reshape(B, -1, dh)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(dt).reshape(-1, dh)
        k_new = k_new + lp["bk"].to(dt).reshape(-1, dh)
        v_new = v_new + lp["bv"].to(dt).reshape(-1, dh)
    posb = pos.reshape(1, 1)
    q = L.apply_rope(q[:, None], posb, cfg.rope_theta)[:, 0]
    k_new = L.apply_rope(k_new[:, None], posb, cfg.rope_theta)[:, 0]
    tp = cfg.tp(mesh)
    if tp > 1:  # K7's shard mode takes every head, contiguous, on each sequence shard
        q = M.all_gather(q, (AXIS_MODEL,), mesh, dim=1).contiguous()
        if cfg.kv_sharded(mesh):
            k_new = M.all_gather(k_new, (AXIS_MODEL,), mesh, dim=1)
            v_new = M.all_gather(v_new, (AXIS_MODEL,), mesh, dim=1)
    k_c = L.kv_cache_update_shard(k_cache, k_new, pos, start)
    v_c = L.kv_cache_update_shard(v_cache, v_new, pos, start)
    attn = L.flash_decode_shard(q, k_c, v_c, cache_len, start, combine, mesh)
    if tp > 1:
        hl = attn.shape[1] // tp
        attn = attn[:, mesh.coords[AXIS_MODEL] * hl:(mesh.coords[AXIS_MODEL] + 1) * hl]
    x = x + L.out_of_model(mm(attn.reshape(B, 1, -1), name="wo"), mesh, False)
    h = _decode_norm(x, lp["ln2"], cfg.norm_eps, par, partial)
    ffn = None
    if cfg.dense_ffn():
        g = torch.nn.functional.silu(mm(h, name="wg")) * mm(h, name="wu")
        ffn = L.out_of_model(mm(g, name="wd"), mesh, False)
    if cfg.moe is not None:
        whole = M.all_gather(h, par.fsdp_axes, mesh, dim=-1) if partial else h
        moe_out = _model_block(L.out_of_model(_moe_partial(cfg, lp, whole, par)[0], mesh, False),
                               par, partial)
        ffn = moe_out if ffn is None else ffn + moe_out
    return x + ffn


def decode_step(cfg: TransformerConfig, params: dict, cache, tokens: torch.Tensor,
                pos: torch.Tensor, mesh=None, batch_axes: tuple[str, ...] = (AXIS_DATA,),
                seq_axes: tuple[str, ...] = (AXIS_MODEL,),
                fsdp_axes: tuple[str, ...] | None = None):
    """One autoregressive step: tokens [B] at position ``pos`` (an int32
    scalar tensor on the params' device) against caches [L,B,S,Hkv,dh].

    Writes each layer's new K and V row into the caches **in place** (the
    reference returns updated copies) and attends to positions ``<= pos``
    with kernel K7 on the card.  Nothing leaves the device: a decode loop can
    feed ``pos + 1`` and the argmax back without a host sync.  Returns
    ``(logits [B, Vp], (k_cache, v_cache))``, the same cache tensors.

    Under ``mesh`` every argument is this rank's block: tokens of its batch
    block (``batch_axes``), the caches by ``cache_specs(cfg, batch_axes,
    seq_axes)``, the params by ``mesh_param_specs(cfg, mesh, fsdp_axes)``
    (``fsdp_axes`` defaults to ``batch_axes``; a serving cell passes its
    own batch axes, which long_500k's ``batch_axes=()`` leaves out) with
    heads and vocab padded for the mesh; the logits are its [B_l, Vp / tp]
    block of the reference's ``P(batch_axes, model)``.  Every rank writes
    the new rows into its shard only (position ``pos`` lives on one),
    attends over its shard with K7's shard mode and combines over
    ``seq_axes`` (``_decode_layer``; the FSDP layouts in
    ``_decode_parallel``).  With ``batch_axes=()`` and ``seq_axes`` every
    axis this is the long_500k layout (B = 1)."""
    if pos.dim() != 0:
        raise NotImplementedError("decode_step: pos must be a scalar (one position "
                                  "for the whole batch)")
    dt = cfg.compute_dtype
    par, partial = _decode_parallel(cfg, mesh, batch_axes, fsdp_axes)
    k_cache, v_cache = cache
    x = L.sharded_vocab_embed(params["embed"], tokens[:, None], mesh, out_dtype=dt)
    x = _model_block(x, par, partial)
    cache_len = (pos + 1).to(torch.int32)
    start, combine = 0, ()
    if mesh is not None and seq_axes:
        combine = tuple(seq_axes)
        start = torch.full((), mesh.index(combine) * k_cache.shape[2], dtype=torch.int32,
                           device=pos.device)
    for li in range(cfg.n_layers):
        x = _decode_layer(cfg, layer_params(params, li), x, k_cache[li], v_cache[li], pos,
                          cache_len, start, combine, par, partial)
    x = _decode_norm(x, params["final_ln"], cfg.norm_eps, par, partial)
    logits = x[:, 0] @ _model_block(params["head"].to(dt), par, partial).T
    if partial:
        logits = M.reduce_from(logits, par.fsdp_axes, mesh)
    return logits, (k_cache, v_cache)
