"""PartitionSpecs for optimizer state, derived from the parameter specs:
port of ``repro/optim/sharding_rules.py``.

Under a mesh each rank keeps the optimizer state of its own block of every
parameter, so the state's layout follows the parameter's: Adam's moments
inherit the param spec; Adafactor's factored stats drop the reduced axis;
rowwise Adagrad keeps only the row axis (one accumulator per row of the
rank's shard).  ``pshapes`` are tensors of the parameters' global shapes
(``meta`` tensors from ``abstract_params`` do).  The specs place a
restored optimizer state (``ckpt.checkpoint.CheckpointManager.restore``)
and cut a whole one into this rank's blocks (``models.layers.constrain``).
"""
from __future__ import annotations

import re
from typing import Any

from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.core.sharding import is_spec
from repro_torch.utils import keystr, tree_flatten_with_path, tree_unflatten


def _norm(spec: P, ndim: int) -> tuple:
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _map(fn, pspecs: Any, pshapes: Any) -> Any:
    """``fn(spec, shape)`` over the leaves of both trees, nested as ``pspecs``."""
    specs = [s for _, s in tree_flatten_with_path(pspecs, is_spec)]
    shapes = [x for _, x in tree_flatten_with_path(pshapes)]
    if len(specs) != len(shapes):
        raise ValueError(f"{len(specs)} specs for {len(shapes)} parameters")
    return tree_unflatten(pspecs, [fn(s, x) for s, x in zip(specs, shapes)], is_spec)


def adam_state_specs(pspecs: Any, pshapes: Any) -> Any:
    return {"m": pspecs, "v": pspecs, "t": P()}


def sgd_state_specs(pspecs: Any, pshapes: Any, momentum: float = 0.0) -> Any:
    return pspecs if momentum else ()


def adafactor_state_specs(pspecs: Any, pshapes: Any) -> Any:
    def one(spec, shape):
        nd = len(shape.shape)
        t = _norm(spec, nd)
        if nd >= 2:
            return {"vr": P(*t[:-1]), "vc": P(*(t[:-2] + (t[-1],)))}
        return {"v": P(*t)}

    return {"s": _map(one, pspecs, pshapes), "t": P()}


def rowwise_adagrad_state_specs(pspecs: Any, pshapes: Any) -> Any:
    return _map(lambda spec, shape: P(_norm(spec, len(shape.shape))[0]), pspecs, pshapes)


def composite_state_specs(rules: list[tuple[str, str]], pspecs: Any, pshapes: Any) -> list:
    """rules: [(regex, kind)] with kind in {adam, adafactor, rowwise, sgd},
    first match wins, as ``optimizers.make_composite`` routes the leaves."""
    fns = {
        "adam": adam_state_specs,
        "adafactor": adafactor_state_specs,
        "rowwise": rowwise_adagrad_state_specs,
        "sgd": sgd_state_specs,
    }
    flat_specs = [s for _, s in tree_flatten_with_path(pspecs, is_spec)]
    flat_shapes = tree_flatten_with_path(pshapes)
    groups: list[list[int]] = [[] for _ in rules]
    for i, (path, _) in enumerate(flat_shapes):
        name = keystr(path)
        for r, (pat, _) in enumerate(rules):
            if re.search(pat, name):
                groups[r].append(i)
                break
        else:
            raise ValueError(f"no rule for {name}")
    return [fns[kind]([flat_specs[i] for i in idxs], [flat_shapes[i][1] for i in idxs])
            for (_, kind), idxs in zip(rules, groups)]
