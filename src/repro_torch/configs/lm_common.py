"""The cells of the LM-family architectures, built by one function.

Port of ``repro/configs/lm_common.py``.  Shape set (assigned): train_4k,
prefill_32k, decode_32k, long_500k.  ``decode_*``/``long_*`` lower
``serve_step`` (``decode_step`` with a sequence-sharded KV cache), not
``train_step``.  long_500k runs with the KV cache sharded over (data x
model) [+ pod] since batch=1 leaves the data axis free.

A cell's arguments are ``meta`` tensors of the global shapes and its
in_shardings the reference's ``PartitionSpec`` trees (``T.param_specs``,
the optimizer's state specs, the batch's ``P(batch_axes, None)``).  Under
a ``launch.mesh.Mesh`` each rank calls the cell's step on its blocks of the
arguments, cut by those specs (``models.recsys.shard_params``): the train
and prefill cells' steps run the tensor-, sequence- and FSDP-parallel
``make_train_step`` and ``prefill`` (the params' layout is
``T.mesh_param_specs``: serving cells with ``fsdp_serve`` gather weight
rows over the batch axes at use), Adafactor's reductions span the mesh;
the decode cell's step is ``decode_step``'s sequence-sharded decode in the
same layout, its weight rows FSDP-split over the cell's batch axes also
where long_500k's B = 1 splits no batch (``fsdp_axes``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs import ArchDef, CellBuild, register
from repro_torch.core.sharding import AXIS_DATA, AXIS_MODEL, AXIS_POD, PartitionSpec as P
from repro_torch.data import synthetic as syn
from repro_torch.models import transformer as T
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import optimizers as opt_lib
from repro_torch.optim import sharding_rules as opt_specs
from repro_torch.utils import resolve_device

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def serving_config(cfg: TransformerConfig) -> TransformerConfig:
    """The config a serving cell runs: bf16 weights (compute stays in the
    config's ``compute_dtype``, bf16 by default)."""
    return dataclasses.replace(cfg, param_dtype=torch.bfloat16)


def make_optimizer(kind: str, mesh=None, specs=None):
    """``(optimizer, state_spec_fn)``: Adam (3e-4) or Adafactor (1e-2) and
    the rule that lays its state out as the params.  Adam updates the params
    and its moments in place, as the train cell donates both
    (``donate_argnums=(0, 1)``): at full size, params, gradients and two
    copies of the moments would not fit one card.  Under a ``mesh``
    Adafactor takes the params' ``specs``: its means span the ranks."""
    if kind == "adam":
        return opt_lib.make_adam(3e-4, in_place=True), opt_specs.adam_state_specs
    if kind == "adafactor":
        return (opt_lib.make_adafactor(1e-2, mesh=mesh, specs=specs),
                opt_specs.adafactor_state_specs)
    raise ValueError(kind)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_lm_cell(base_cfg: TransformerConfig, opt_kind: str, shape: str, mesh,
                  multi_pod: bool, fsdp_serve: bool = False) -> CellBuild:
    info = LM_SHAPES[shape]
    batch_axes = (AXIS_POD, AXIS_DATA) if multi_pod else (AXIS_DATA,)
    S, B = info["seq"], info["batch"]

    if info["kind"] == "train":
        cfg = dataclasses.replace(base_cfg, param_dtype=torch.float32)
        pshapes = T.abstract_params(cfg, mesh)
        # HSDP: weights and optimizer state shard over every data-parallel axis
        # (pod x data on the multi-pod mesh).
        pspecs = T.param_specs(cfg, mesh, training=True, fsdp_axes=batch_axes)
        optimizer, state_spec_fn = make_optimizer(opt_kind, mesh,
                                                  pspecs if mesh is not None else None)
        sshapes = optimizer.init(pshapes)
        sspecs = state_spec_fn(pspecs, pshapes)
        batch_abs = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
        bspecs = {"tokens": P(batch_axes, None), "labels": P(batch_axes, None)}
        step = T.make_train_step(cfg, optimizer, mesh, batch_axes, grad_specs=pspecs)
        return CellBuild("train_step", step, (pshapes, sshapes, batch_abs),
                         (pspecs, sspecs, bspecs), donate_argnums=(0, 1))

    # Serving cells: bf16 weights; big archs keep FSDP-style sharding so the
    # weights fit one pod.
    cfg = dataclasses.replace(base_cfg, param_dtype=torch.bfloat16, fsdp=fsdp_serve,
                              microbatches=1)
    pshapes = T.abstract_params(cfg, mesh)
    pspecs = T.param_specs(cfg, mesh, training=fsdp_serve, fsdp_axes=batch_axes)

    if info["kind"] == "prefill":
        def prefill_step(params, tokens):
            return T.prefill(cfg, params, tokens, mesh, batch_axes)

        return CellBuild("serve_prefill", prefill_step, (pshapes, _meta((B, S), torch.int32)),
                         (pspecs, P(batch_axes, None)))

    # decode
    if B == 1:
        dec_batch_axes: tuple[str, ...] = ()
        seq_axes = tuple(mesh.axis_names)  # (pod,)data,model
    else:
        dec_batch_axes = batch_axes
        seq_axes = (AXIS_MODEL,)
    cache_abs = tuple(_meta((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head), torch.bfloat16)
                      for _ in range(2))
    cspec = T.cache_specs(cfg, dec_batch_axes, seq_axes)
    tok_spec = P(dec_batch_axes) if dec_batch_axes else P(None)

    def serve_step(params, cache, tokens, pos):
        # the weight rows stay FSDP-split over the cell's batch axes, also
        # where B = 1 leaves the batch unsplit
        return T.decode_step(cfg, params, cache, tokens, pos, mesh, dec_batch_axes, seq_axes,
                             fsdp_axes=batch_axes)

    return CellBuild("serve_decode", serve_step,
                     (pshapes, cache_abs, _meta((B,), torch.int32), _meta((), torch.int32)),
                     (pspecs, (cspec, cspec), tok_spec, P()), donate_argnums=(1,))


def smoke_config(base_cfg: TransformerConfig) -> TransformerConfig:
    """The smoke's reduced config of ``base_cfg``'s family: 2 layers, d_model
    64, 4 query heads of 16 with the KV heads cut in proportion (at least
    one), vocab 256, 4 experts, f32 params and compute."""
    moe = base_cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=4, top_k=min(2, moe.top_k), d_ff=32)
    return dataclasses.replace(
        base_cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, base_cfg.n_kv_heads * 4 // base_cfg.n_heads),
        d_head=16,
        d_ff=128,
        vocab=256,
        moe=moe,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        seq_shard=False,
        remat_groups=2,
        fsdp=False,
        q_block=8,
    )


def lm_smoke(base_cfg: TransformerConfig, opt_kind: str = "adam", device="cuda") -> dict:
    """Reduced-config smoke (``smoke_config``: head dim 16, f32); one train
    step and one decode step on ``device`` (the card unless the caller
    passes "cpu"), checking shapes and finiteness."""
    cfg = smoke_config(base_cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    params = T.init_params(cfg, seed=0, device=dev)
    optimizer, _ = make_optimizer(opt_kind)
    state = optimizer.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in syn.lm_batch(rng, cfg.vocab, 4, 16).items()}
    params, state, metrics = T.make_train_step(cfg, optimizer, None)(params, state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"{cfg.name} smoke: train loss {loss}")

    cache = T.init_decode_cache(cfg, 4, 32, torch.float32, device=dev)
    with torch.no_grad():
        logits, cache = T.decode_step(cfg, params, cache, batch["tokens"][:, 0],
                                      torch.zeros((), dtype=torch.int32, device=dev))
    if logits.shape != (4, cfg.padded_vocab(None)) or not bool(torch.isfinite(logits).all()):
        raise FloatingPointError(f"{cfg.name} smoke: decode logits {tuple(logits.shape)} "
                                 "not finite")
    return {"loss": loss, "logits_shape": tuple(logits.shape)}


def register_lm(arch_id: str, base_cfg: TransformerConfig, opt_kind: str, fsdp_serve: bool,
                kind: str, notes: str = "") -> ArchDef:
    return register(
        ArchDef(
            id=arch_id,
            kind=kind,
            shapes=tuple(LM_SHAPES),
            build_cell=functools.partial(_build, base_cfg=base_cfg, opt_kind=opt_kind,
                                         fsdp_serve=fsdp_serve),
            smoke=functools.partial(lm_smoke, base_cfg, opt_kind),
            notes=notes,
        )
    )


def _build(shape, mesh, multi_pod, *, base_cfg, opt_kind, fsdp_serve):
    return build_lm_cell(base_cfg, opt_kind, shape, mesh, multi_pod, fsdp_serve)
