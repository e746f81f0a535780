"""Optimizers as transforms of nested params: port of ``repro/optim/optimizers.py``.

Production mix used by the trainer:
  * adam            — default for dense parameters.
  * adafactor       — factored second moments, so optimizer state stays
                      O(rows + cols) per matrix.
  * rowwise_adagrad — the embedding-table optimizer (one accumulator per
                      *row*, so a table carries only O(rows) extra state),
                      as FBGEMM/TorchRec.
  * composite       — key-path routing, e.g. tables -> rowwise_adagrad,
                      dense -> adam.

Params, grads and state are nested dicts, lists and tuples of tensors.
Every tree is walked in JAX's flatten order (``utils.tree_flatten_with_path``:
dict keys sorted), so a state has the reference's structure and a
checkpoint's leaf keys match the reference's.  ``update`` is functional, as
the reference's: it returns new params and state and changes none of its
arguments (but ``make_adam(..., in_place=True)``'s, which donates them).
It runs under ``torch.no_grad()`` on the params' device and never waits for
the device: step counts and bias corrections stay tensors there.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import torch

from repro_torch.core.sharding import is_spec
from repro_torch.launch.mesh import all_reduce
from repro_torch.utils import keystr, tree_flatten_with_path, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    return tree_unflatten(tree, [fn(*xs) for xs in zip(_leaves(tree), *map(_leaves, rest))])


def _unzip(tree, outs: list, n: int) -> list:
    """``n`` trees shaped as ``tree`` from a list of n-tuples, one a leaf."""
    return [tree_unflatten(tree, [o[k] for o in outs]) for k in range(n)]


def _device(tree) -> torch.device:
    leaves = _leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _step_count(tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(tree))


def make_sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return _map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params):
        if momentum == 0.0:
            return _map(lambda p, g: p - lr * g.to(p.dtype), params, grads), state
        new_state = _map(lambda m, g: momentum * m + g, state, grads)
        new_params = _map(lambda p, m: p - lr * m.to(p.dtype), params, new_state)
        return new_params, new_state

    return Optimizer(init, update)


def make_adam(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    in_place: bool = False,
) -> Optimizer:
    """Adam.  With ``in_place`` the update writes the new params and moments
    into the tensors it is given (the reference's ``donate_argnums=(0, 1)``
    of a train cell) and returns them: the same values as the functional
    update, computed leaf by leaf, so only one leaf's temporaries live
    beside the params, gradients and moments (a model whose params,
    gradients and two copies of the state would not fit the card).  The
    LM's optimizer (``configs.lm_common.make_optimizer``, which
    ``launch.train --model lm`` and the LM cells take) selects it."""

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=F32)  # noqa: E731
        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "t": _step_count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        t = state["t"] + 1
        bc1 = 1.0 - b1 ** t.to(F32)
        bc2 = 1.0 - b2 ** t.to(F32)

        def upd(p, g, m, v):
            g = g.to(F32)
            m1 = b1 * m + (1 - b1) * g
            v1 = b2 * v + (1 - b2) * g * g
            step = lr * (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.to(F32)
            return (p.to(F32) - step).to(p.dtype), m1, v1

        leaves = zip(_leaves(params), _leaves(grads), _leaves(state["m"]), _leaves(state["v"]))
        if in_place:
            for p, g, m, v in leaves:
                for old, new in zip((p, m, v), upd(p, g, m, v)):
                    old.copy_(new)
            return params, {"m": state["m"], "v": state["v"], "t": t}
        new_p, new_m, new_v = _unzip(params, [upd(*xs) for xs in leaves], 3)
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)


def make_adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    mesh=None,
    specs=None,
) -> Optimizer:
    """Adafactor (Shazeer & Stern) without momentum: factored 2nd moments for
    params with ndim >= 2 (over the last two dims), full accumulator otherwise.
    A stacked parameter (ndim >= 3) is updated layer by layer, a loop over its
    leading dim, as the reference's ``lax.map``: each layer clips by its own RMS.

    Under a ``mesh`` each rank updates its blocks of the params laid out as
    ``specs`` (a tree of PartitionSpecs shaped as the params), with the
    state laid out by ``sharding_rules.adafactor_state_specs``.  The means
    that reduce a dim the specs split (the factored row and column means,
    the row mean of their ratio's denominator and the RMS of the clip) are
    each a local sum, all-reduced over the axes that split the reduced
    dims, over the global count."""
    if (mesh is None) != (specs is None):
        raise ValueError("make_adafactor: a mesh needs the params' specs, and specs a mesh")

    def init(params):
        def one(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=F32)}

        return {"s": _map(one, params), "t": _step_count(params)}

    def mean(x, dims: tuple, dim_axes, keepdim: bool = False):
        """The mean over ``dims`` (None: every dim) of the whole tensor this
        rank holds a block of, split along each dim over ``dim_axes[dim]``
        (None: no mesh)."""
        if dim_axes is None:
            return x.mean() if dims is None else x.mean(dim=dims, keepdim=keepdim)
        dims = tuple(range(x.ndim)) if dims is None else dims
        axes = tuple(a for d in dims for a in dim_axes[d])
        total = x.sum(dim=dims, keepdim=keepdim)
        count = math.prod(x.shape[d] for d in dims)
        if axes:
            total = all_reduce(total, axes, mesh)
            count *= mesh.axis_size(axes)
        return total / count

    @torch.no_grad()
    def update(grads, state, params):
        t = state["t"] + 1
        beta = 1.0 - t.to(F32) ** (-decay)

        def upd_one(p, g, s, dim_axes):
            """One logical (<= 2D-factored) parameter."""
            g = g.to(F32)
            g2 = g * g + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * mean(g2, (-1,), dim_axes)
                vc = beta * s["vc"] + (1 - beta) * mean(g2, (-2,), dim_axes)
                denom = mean(vr, (-1,), None if dim_axes is None else dim_axes[:-1],
                             keepdim=True)
                r = (vr / torch.clamp_min(denom, eps))[..., None]
                c = vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp_min(r * c, eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp_min(v, eps))
                new_s = {"v": v}
            rms_u = torch.sqrt(mean(u * u, None, dim_axes) + eps)
            u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
            return (p.to(F32) - lr * u).to(p.dtype), new_s

        def upd(p, g, s, spec):
            dim_axes = None if spec is None else [spec.axes_of(d) for d in range(p.ndim)]
            if p.ndim >= 3:
                inner = None if dim_axes is None else dim_axes[1:]
                layers = [upd_one(p[i], g[i], {k: v[i] for k, v in s.items()}, inner)
                          for i in range(p.shape[0])]
                return (torch.stack([lp for lp, _ in layers]),
                        {k: torch.stack([ls[k] for _, ls in layers]) for k in s})
            return upd_one(p, g, s, dim_axes)

        pleaves = _leaves(params)
        spec_leaves = ([sp for _, sp in tree_flatten_with_path(specs, is_spec)]
                       if specs is not None else [None] * len(pleaves))
        if len(spec_leaves) != len(pleaves):
            raise ValueError(f"make_adafactor: {len(spec_leaves)} specs for "
                             f"{len(pleaves)} params")
        outs = [upd(*xs) for xs in zip(pleaves, _leaves(grads),
                                        _subtrees(params, state["s"]), spec_leaves)]
        new_p, new_s = _unzip(params, outs, 2)
        return new_p, {"s": new_s, "t": t}

    return Optimizer(init, update)


def _subtrees(prefix, tree) -> list:
    """The subtrees of ``tree`` at the leaves of ``prefix``, whose nesting
    ``tree`` extends (Adafactor's state dict of each parameter), in flatten
    order: the reference's ``tree_map`` over params and state."""
    if isinstance(prefix, dict):
        return [x for k in sorted(prefix) for x in _subtrees(prefix[k], tree[k])]
    if isinstance(prefix, (list, tuple)):
        return [x for p, t in zip(prefix, tree) for x in _subtrees(p, t)]
    return [] if prefix is None else [tree]


def make_rowwise_adagrad(lr: float = 0.05, eps: float = 1e-8) -> Optimizer:
    """One accumulator per embedding row (FBGEMM-style)."""

    def init(params):
        return _map(lambda p: torch.zeros(p.shape[:1], dtype=F32, device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params):
        def upd(p, g, a):
            g = g.to(F32)
            sq = g * g
            if g.ndim > 1:
                sq = sq.mean(dim=tuple(range(1, g.ndim)))
            a1 = a + sq
            shape = a1.shape + (1,) * (g.ndim - 1)
            step = lr * g * torch.rsqrt(a1.reshape(shape) + eps)
            return (p.to(F32) - step).to(p.dtype), a1

        outs = [upd(*xs) for xs in zip(_leaves(params), _leaves(grads), _leaves(state))]
        return tuple(_unzip(params, outs, 2))

    return Optimizer(init, update)


def make_composite(rules: list[tuple[str, Optimizer]]) -> Optimizer:
    """Route params to optimizers by regex over the key path
    (``utils.keystr``, e.g. ``"['emb']['table']"``).

    rules: ordered [(pattern, optimizer)]; first match wins; last rule should
    be a catch-all ('.*', default_opt).  The state is a list with one entry
    per rule, each its optimizer's state over the list of its leaves."""

    def _split(params):
        flat = tree_flatten_with_path(params)
        groups: list[list[int]] = [[] for _ in rules]
        for i, (path, _) in enumerate(flat):
            name = keystr(path)
            for r, (pat, _) in enumerate(rules):
                if re.search(pat, name):
                    groups[r].append(i)
                    break
            else:
                raise ValueError(f"no optimizer rule matches {name}")
        return [leaf for _, leaf in flat], groups

    def init(params):
        leaves, groups = _split(params)
        return [opt.init([leaves[i] for i in idxs])
                for (_, opt), idxs in zip(rules, groups)]

    def update(grads, state, params):
        pleaves, groups = _split(params)
        gleaves = _leaves(grads)
        new_leaves: list = [None] * len(pleaves)
        new_states = []
        for (_, opt), idxs, st in zip(rules, groups, state):
            new_p, new_s = opt.update([gleaves[i] for i in idxs], st,
                                      [pleaves[i] for i in idxs])
            for j, i in enumerate(idxs):
                new_leaves[i] = new_p[j]
            new_states.append(new_s)
        return tree_unflatten(params, new_leaves), new_states

    return Optimizer(init, update)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, mesh=None, specs=None):
    """``(grads * min(1, max_norm / norm), norm)``, norm the global L2 norm
    as a 0-dim f32 tensor on the grads' device.

    Under a ``mesh`` each rank holds its blocks of the (already reduced)
    gradients laid out as ``specs`` (a tree of PartitionSpecs shaped as
    ``grads``): a leaf's squared sum is summed over the mesh axes its spec
    splits it over, so a sharded leaf counts every shard and a replicated
    one counts once."""
    leaves = _leaves(grads)
    sq = [torch.sum(leaf.to(F32) ** 2) for leaf in leaves]
    if mesh is not None:
        by_axes: dict[tuple, torch.Tensor] = {}
        for s, (_, spec) in zip(sq, tree_flatten_with_path(specs, is_spec)):
            axes = mesh.axes(spec.mesh_axes())
            by_axes[axes] = by_axes.get(axes, 0) + s
        sq = [all_reduce(v, axes, mesh) if axes else v for axes, v in by_axes.items()]
    norm = torch.sqrt(sum(sq))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm
