"""Asynchronous, reshardable checkpoints with the reference's on-disk
layout: port of ``repro/ckpt/checkpoint.py``.

Layout: <dir>/step_<N>/
  manifest.json        — step, per-leaf key/file/shape/dtype, sharding spec
                         (as recorded at save), extra state (data-pipeline
                         position), save wall-time.
  leaf_%05d.npy        — one leaf, the whole logical array.

Leaves are keyed by ``utils.keystr`` in JAX's flatten order, so a checkpoint
written by either package restores in the other.

  * async: ``save`` copies every leaf to host memory synchronously (a
    blocking device-to-host copy, so the next step's update cannot race it),
    then a background thread writes the files; ``wait()`` joins before the
    next save.
  * atomicity: writes land in step_<N>.tmp, renamed at the end; a crashed
    save never shadows the previous checkpoint (restart safety).
  * restore places each leaf on its template leaf's device in its dtype.
  * restore is *resharding*: the files hold logical arrays, and under a
    ``launch.mesh.Mesh`` each rank reads only its block of a leaf that has
    a spec (``np.load(mmap_mode="r")`` and a slice), whatever mesh saved
    it.  ``save(mesh=...)`` gathers each sharded leaf whole (collectives on
    every rank) and rank 0 writes.

f32 and int32 leaves are the training path's; a bfloat16 leaf raises (the
reference stores bfloat16 through ``ml_dtypes``, which numpy alone cannot
read back).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.sharding import PartitionSpec, is_spec
from repro_torch.launch import mesh as M
from repro_torch.utils import keystr, logger, tree_flatten_with_path, tree_unflatten

__all__ = ["CheckpointManager", "PartitionSpec"]


def _flatten(tree: Any, is_leaf=None) -> list[tuple[str, Any]]:
    return [(keystr(path), leaf) for path, leaf in tree_flatten_with_path(tree, is_leaf)]


def _spec_to_json(spec: PartitionSpec | None):
    """As the reference writes a spec: a list, tuples of names as lists."""
    if spec is None:
        return None
    return [list(el) if isinstance(el, (tuple, list)) else el for el in spec]


def _spec_from_json(obj) -> PartitionSpec:
    if obj is None:
        return PartitionSpec()
    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e for e in obj])


def _gather_whole(leaf: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The logical array of which ``leaf`` is this rank's block under ``spec``."""
    for d in range(leaf.ndim):
        axes = spec.axes_of(d)
        if axes:
            if mesh.axes(axes) != axes:
                raise ValueError(f"spec {spec}: dim {d}'s axes are not in the mesh's order")
            leaf = M.all_gather(leaf, axes, mesh, dim=d)
    return leaf


def _to_host(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"{key}: bfloat16 leaves are not checkpointed by this "
                            "package (the reference stores them through ml_dtypes)")
        # a blocking copy to host memory, a copy on the CPU too: the caller
        # may update the leaf in place while the writer thread runs
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save

    def save(
        self,
        step: int,
        tree: Any,
        specs: Any = None,
        extra: dict | None = None,
        blocking: bool = False,
        mesh=None,
    ) -> None:
        """Snapshot to host memory, then serialize in the background.

        Under a ``mesh`` every rank calls it with its blocks: each leaf with
        a spec is gathered whole, rank 0 writes, and a blocking save ends
        at a barrier (every rank may then restore it)."""
        self.wait()
        spec_map = dict(_flatten(specs, is_spec))
        flat = _flatten(tree)
        if mesh is not None:
            flat = [(k, _gather_whole(v, spec_map[k], mesh) if k in spec_map else v)
                    for k, v in flat]
            if mesh.rank != 0:
                if blocking:
                    mesh.barrier()
                return
        host = [(k, _to_host(k, v)) for k, v in flat]

        def _write():
            t0 = time.time()
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {
                "step": step,
                "extra": extra or {},
                "leaves": [],
                "save_seconds": None,
            }
            for i, (key, arr) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"].append(
                    {
                        "key": key,
                        "file": fname,
                        "shape": list(arr.shape),
                        "dtype": str(arr.dtype),
                        "spec": _spec_to_json(spec_map.get(key)),
                    }
                )
            manifest["save_seconds"] = time.time() - t0
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()
            logger.info("checkpoint step %d saved (%.2fs)", step, manifest["save_seconds"])

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()
            if mesh is not None:
                mesh.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None, mesh=None,
                specs: Any = None, device=None) -> tuple[Any, dict]:
        """Restore into ``template``'s structure (tensors, or anything with
        ``shape``, ``dtype`` and ``device``, such as ``meta`` tensors of
        ``abstract_params``; shapes are the logical arrays'): each leaf in
        its template leaf's dtype, on ``device`` or else the template leaf's
        (a ``meta`` template needs ``device``: restoring onto meta raises).

        Under a ``mesh`` a leaf with a spec (from ``specs``, else the one
        recorded at save) comes back as this rank's block, read from the
        file by a memory map and a slice: a rank reads its rows only.
        Without a mesh ``specs`` is unused and every leaf comes back whole."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        spec_map = dict(_flatten(specs, is_spec))
        leaves = []
        for key, tmpl in _flatten(template):
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            rec = by_key[key]
            if rec["dtype"] == "bfloat16" or tmpl.dtype == torch.bfloat16:
                raise TypeError(f"{key}: bfloat16 leaves are not restored by this "
                                "package (the reference stores them through ml_dtypes)")
            arr = np.load(d / rec["file"], mmap_mode="r")
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != template {tuple(tmpl.shape)}"
                )
            spec = spec_map.get(key)
            if spec is None and rec["spec"] is not None:
                spec = _spec_from_json(rec["spec"])
            if mesh is not None and spec is not None:
                arr = arr[M.block_slices(arr.shape, spec, mesh)]
            dest = torch.device(device) if device is not None else tmpl.device
            if dest.type == "meta":
                raise ValueError(f"{key}: the template leaf is on the meta device, which "
                                 "holds no data; pass device= to restore onto")
            leaves.append(torch.from_numpy(np.array(arr)).to(device=dest, dtype=tmpl.dtype))
        return tree_unflatten(template, leaves), manifest["extra"]
