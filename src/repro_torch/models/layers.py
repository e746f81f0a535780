"""Shared dense layers: the MLP stack of the DLRM dense model.

Port of ``dense_init``, ``mlp_params`` and ``mlp_apply`` of
``repro/models/layers.py``; the norm, rotary and attention helpers wait for
the LM slice of the port.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """[d_in, d_out] weight, uniform in +-1/sqrt(d_in)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=dtype, device=device)
    return w.uniform_(-scale, scale, generator=gen)


def mlp_params(gen: torch.Generator, sizes: Sequence[int], dtype=torch.float32,
               device="cuda", bias: bool = True) -> dict:
    """Plain MLP stack parameters: sizes = [d_in, h1, ..., d_out]."""
    params = {}
    for i in range(len(sizes) - 1):
        params[f"w{i}"] = dense_init(gen, sizes[i], sizes[i + 1], dtype, device)
        if bias:
            params[f"b{i}"] = torch.zeros((sizes[i + 1],), dtype=dtype,
                                          device=device)
    return params


def mlp_apply(
    params: dict,
    x: torch.Tensor,
    act: Callable = torch.relu,
    final_act: bool = False,
) -> torch.Tensor:
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"].to(x.dtype)
        if f"b{i}" in params:
            x = x + params[f"b{i}"].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x
