"""Small shared utilities: device resolution, nested-dict tensor helpers, timing."""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Iterator

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device an entry point runs on.  A CUDA device with no GPU
    present raises: the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is present; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def numpy_to_tensor(a) -> torch.Tensor:
    """A CPU tensor holding a writable copy of ``a`` (jax leaves are
    read-only); ml_dtypes bfloat16 arrays keep their bits."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict/list/tuple, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_flatten_with_path(tree: Any, is_leaf=None,
                           _path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's flatten order: dict keys sorted,
    lists and tuples by index; ``None`` and empty containers hold no leaf;
    a subtree for which ``is_leaf`` is true is a leaf.  A path is the tuple
    of keys and indices from the root, as
    ``jax.tree_util.tree_flatten_with_path`` gives (``keystr`` prints it)."""
    if is_leaf is not None and is_leaf(tree):
        return [(_path, tree)]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k], is_leaf, _path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_flatten_with_path(v, is_leaf, _path + (i,))]
    if tree is None:
        return []
    return [(_path, tree)]


def keystr(path: tuple) -> str:
    """The key string ``jax.tree_util.keystr`` gives for a path of
    :func:`tree_flatten_with_path`: ``"['emb']['table']"``, ``"[0]"``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_unflatten(template: Any, leaves, is_leaf=None) -> Any:
    """``template``'s nesting with its leaves replaced, in the order of
    :func:`tree_flatten_with_path`, by ``leaves``; dicts keep the
    template's insertion order; a subtree for which ``is_leaf`` is true is
    a leaf."""
    it = iter(leaves)
    end = object()

    def take():
        leaf = next(it, end)
        if leaf is end:
            raise ValueError("fewer leaves than the template holds")
        return leaf

    def fill(t):
        if is_leaf is not None and is_leaf(t):
            return take()
        if isinstance(t, dict):
            out = {k: fill(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)([fill(v) for v in t])
        if t is None:
            return None
        return take()

    out = fill(template)
    if next(it, end) is not end:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_to(tree: Any, device: str | torch.device) -> Any:
    """Move every tensor leaf to ``device``."""
    return tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree
    )


def tree_size_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves."""
    return sum(
        x.numel() * x.element_size()
        for x in tree_leaves(tree) if isinstance(x, torch.Tensor)
    )


def tree_num_params(tree: Any) -> int:
    return sum(x.numel() for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


@contextlib.contextmanager
def timed(label: str, sink: dict | None = None) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = dt
    logger.info("%s: %.3fs", label, dt)


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def check_finite(tree: Any, where: str = "", _path: str = "") -> None:
    """NaN/Inf check over a nested dict of tensors, for tests and smoke runs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            check_finite(v, where, f"{_path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            check_finite(v, where, f"{_path}[{i}]")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        if not bool(torch.isfinite(tree).all()):
            raise FloatingPointError(f"non-finite values at {where}{_path}")
