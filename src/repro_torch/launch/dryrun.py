"""Dry run: trace one rank's step of every (arch x shape) cell on the
production meshes, on the ``meta`` device, and report its per-device
memory, FLOPs, bytes and collective bytes on an H100.

Port of ``repro/launch/dryrun.py``, which lowers and compiles each cell
with XLA.  Here the cell is built under a ``launch.mesh.DryMesh`` (one
rank of the 16x16 pod, or of 2x16x16 with ``--multi-pod``, with no
processes behind it), the rank's blocks of its arguments are cut from the
cell's layouts as the card's mesh paths cut them, and the step runs once
on meta tensors under ``launch.hlo_analysis.Trace``: every aten op, every
hand kernel (whose wrapper reports its work and launches nothing) and
every collective (which sends nothing) is counted, and nothing allocates
device memory.  Every rank's blocks have the same shapes but the
molecule cell's, whose last model ranks hold fewer graphs or none
(``models.gnn.model_block``); ``--rank`` picks the rank traced.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch wide-deep --shape train_batch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 cells, 1 pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json,
apart from the reference's experiments/dryrun/.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.core.sharding import is_spec
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as M
from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_unflatten

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def rank_blocks(args, shardings, mesh):
    """The rank's blocks of the cell's meta arguments under ``shardings``
    (a tree of PartitionSpec matching ``args``), each a meta tensor of its
    own: a block's bytes are its own, not the whole argument's."""
    leaves = [x for _, x in tree_flatten_with_path(args)]
    specs = [s for _, s in tree_flatten_with_path(shardings, is_spec)]
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} arguments against {len(specs)} layouts")
    blocks = []
    for x, spec in zip(leaves, specs):
        if not isinstance(x, torch.Tensor) or x.device.type != "meta":
            raise TypeError(f"a cell's arguments are meta tensors, got {type(x).__name__}")
        shape = x[M.block_slices(x.shape, spec, mesh)].shape
        blocks.append(torch.empty(shape, dtype=x.dtype, device="meta"))
    return tree_unflatten(args, blocks)


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def memory_analysis(args, donated, out, trace: hlo_analysis.Trace) -> dict:
    """The port's ``memory_analysis()``: the rank's argument blocks, its
    outputs, the step's peak of live storages it created less the outputs
    it created (``temp``), and the outputs that are donated arguments
    updated in place (``alias``: Adam's params and moments).  Nothing is
    compiled, so ``generated_code`` is 0.  ``per_device_total`` = argument
    + output + temp - alias, the reference's sum: the arguments and the
    step's peak."""
    donated_keys = {_storage(t) for t in _tensors(donated)}
    outs = _tensors(out)
    alias = _bytes(t for t in outs if _storage(t) in donated_keys)
    created = _bytes(t for t in outs if _storage(t) in trace.created)
    mem = {"argument_size_in_bytes": _bytes(_tensors(args)), "output_size_in_bytes": _bytes(outs),
           "temp_size_in_bytes": max(0, trace.peak_bytes - created),
           "alias_size_in_bytes": alias, "generated_code_size_in_bytes": 0}
    mem["per_device_total"] = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                               + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    return mem


def cost_analysis(trace: hlo_analysis.Trace) -> dict:
    """What the reference's ``cost_analysis()`` holds in spirit: FLOPs by
    product class (and the aten ops' share), each hand kernel's launches and
    work, each collective's calls, bytes and seconds, the peak live bytes."""
    return {"flops_by_class": dict(trace.flops), "aten_flops_by_class": dict(trace.aten_flops),
            "kernels": trace.kernels, "collectives": trace.collectives,
            "peak_live_bytes": trace.peak_bytes}


def run_cell(arch_id: str, shape: str, multi_pod: bool, out_dir=OUT_DIR, rank: int = 0) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    mesh = M.DryMesh(*M.PRODUCTION_SHAPES[multi_pod], rank=rank)
    n_devices = math.prod(mesh.shape.values())
    build = configs.get(arch_id).build_cell(shape, mesh, multi_pod)
    args = rank_blocks(build.args, build.in_shardings, mesh)
    with hlo_analysis.Trace() as trace:
        out = build.step_fn(*args)
    mem = memory_analysis(args, [args[i] for i in build.donate_argnums], out, trace)
    terms = hlo_analysis.analyze(trace)
    del out
    record = {
        "arch": arch_id,
        "shape": shape,
        "mesh": mesh_name,
        "step": build.step_name,
        "n_devices": n_devices,
        "ok": True,
        "compile_seconds": round(time.time() - t0, 1),  # the trace's seconds
        "memory_analysis": mem,
        "cost_analysis_raw": cost_analysis(trace),
        "roofline": terms.as_dict(),
    }

    print(f"== {arch_id} x {shape} x {mesh_name} [{build.step_name}] rank {rank} ==")
    print(f"  memory_analysis: {mem} ({mem['per_device_total'] / hlo_analysis.HBM_BYTES:.2f}x "
          "an H100's 80 GB)")
    print(
        f"  cost: flops/dev={terms.flops_per_device:.3e} "
        f"bytes/dev={terms.bytes_per_device:.3e} "
        f"coll_bytes/dev={terms.collective_bytes_per_device:.3e}"
    )
    print(
        f"  roofline: compute={terms.compute_s*1e3:.3f}ms "
        f"memory={terms.memory_s*1e3:.3f}ms "
        f"collective={terms.collective_s*1e3:.3f}ms "
        f"-> {terms.dominant}-bound"
    )

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = out_dir / f"{arch_id}__{shape}__{mesh_name}.json"
    fname.write_text(json.dumps(record, indent=2))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all assigned cells")
    ap.add_argument("--include-paper-arch", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--rank", type=int, default=0, help="the mesh rank traced")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out_dir)

    if args.all:
        archs = list(configs.ASSIGNED)
        if args.include_paper_arch:
            archs.append("dlrm-flexemr")
    elif args.arch:
        archs = [args.arch]
    else:
        ap.error("--arch or --all required")

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = []
    for arch_id in archs:
        arch = configs.get(arch_id)
        shapes = [args.shape] if args.shape else list(arch.shapes)
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch_id, shape, mp, out_dir, args.rank)
                except Exception as e:  # noqa: BLE001 - reported, then exit 1
                    traceback.print_exc()
                    failures.append((arch_id, shape, mp, repr(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-run cells traced OK")


if __name__ == "__main__":
    main()
