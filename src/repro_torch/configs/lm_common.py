"""The LM family's shape set and serving config.

Port of ``LM_SHAPES`` and the serving-config rule of
``repro/configs/lm_common.py`` (bf16 weights for the serving cells).  The
registry, ``build_lm_cell`` and ``lm_smoke`` are tools of the reference's
dry-run and wait for the slice that ports it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import TransformerConfig

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
