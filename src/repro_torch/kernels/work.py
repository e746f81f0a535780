"""What a hand-kernel launch or a collective does, told to whoever watches.

Every kernel wrapper reports each launch with :func:`kernel`, once, just
before it launches; on the ``meta`` device it then returns (the dry run
launches nothing).  The work is the kernel's own formula over its shapes (its
``*_work`` function beside the wrapper), the same on both devices: the bytes
the function must move, each input read once and each output written once,
and its products by class (``bf16`` tensor cores; ``tf32``, three products
each for the 3xTF32 designs; ``f32`` FMAs).  Where the work depends on the
data, the formula takes what the shapes give, and its docstring says which
way that errs.  ``launch.mesh`` reports each collective with
:func:`collective`.  The dry run's trace (``launch.hlo_analysis.Trace``)
watches both; with no watcher a report costs one list check and computes
nothing.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import torch

CLASSES = ("bf16", "tf32", "f32")  # product classes, by the peak that bounds them


@dataclasses.dataclass(frozen=True)
class Work:
    """One launch's bytes and products (multiply and add counted apart)."""

    bytes: float
    bf16: float = 0.0
    tf32: float = 0.0
    f32: float = 0.0


_watchers: list = []
_lock = threading.Lock()


def watch(watcher) -> None:
    """Send every report to ``watcher.on_kernel(names, work)`` and
    ``watcher.on_collective(op, nbytes, ranks)`` until :func:`unwatch`.
    Reports come from any thread (autograd runs a card's backward in its
    own)."""
    with _lock:
        _watchers.append(watcher)


def unwatch(watcher) -> None:
    with _lock:
        _watchers.remove(watcher)


def kernel(names: tuple[str, ...], work_fn: Callable[..., Work], *args) -> None:
    """One launch of the kernel ``names[0]``, counted also under the other
    ``names`` (its mode: ``embedding_bag_masked``, ``flash_attention_f32``,
    ...); ``work_fn(*args)`` is evaluated only when someone watches."""
    if not _watchers:
        return
    work = work_fn(*args)
    for w in list(_watchers):
        w.on_kernel(names, work)


def collective(op: str, nbytes: float, result_bytes: int,
               ranks_fn: Callable[..., tuple[int, ...]], *args) -> None:
    """One collective of ``op`` moving ``nbytes`` a device (the ring model)
    into a result of ``result_bytes`` among the global ranks
    ``ranks_fn(*args)``, evaluated only when someone watches."""
    if not _watchers:
        return
    ranks = ranks_fn(*args)
    for w in list(_watchers):
        w.on_collective(op, nbytes, result_bytes, ranks)


def on_meta(t: torch.Tensor) -> bool:
    """The dry run's device: the wrapper reports its work and launches nothing."""
    return t.device.type == "meta"
