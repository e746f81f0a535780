"""Small shared utilities: device resolution, nested-dict tensor helpers, timing."""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Iterator

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


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict/list/tuple, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


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
