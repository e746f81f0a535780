#!/usr/bin/env python3
"""What it costs ``launch.mesh.spawn`` to start ranks on one card.

    python3 tools/spawn_ipc_cost.py      # from the repo root, one NVIDIA GPU

Spawns 4 gloo ranks three times and prints, for each, the seconds from the
spawn to each rank's first line of work: with no CUDA tensor among the
arguments, with 128 small CUDA tensors (each shared through its own CUDA
IPC handle, as a tree of params and optimizer state is), and with one view
of a 16 GB allocation.  The ranks are the ones ``chip_smoke.py``'s sharded
phases start.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

RANKS = 4


def started(rank: int, world: int, t_spawn: float, tensors) -> float:
    """Seconds from the spawn to this rank's start, after touching every tensor."""
    t = time.time() - t_spawn
    torch.cuda.synchronize()
    return t if all(x.is_cuda for x in tensors) else -1.0


def main() -> int:
    if not torch.cuda.is_available():
        print("spawn_ipc_cost: no CUDA GPU present", file=sys.stderr)
        return 1
    from repro_torch.launch import mesh as M

    dev = torch.device("cuda")
    big = torch.empty((1 << 32,), dtype=torch.float32, device=dev)  # 16 GB
    cases = {"no CUDA tensor": [], "128 CUDA tensors of 4 KB": [
        torch.zeros(1024, device=dev) for _ in range(128)],
        "one view of a 16 GB allocation": [big[: 1 << 30]]}
    out = {}
    for name, tensors in cases.items():
        t0 = time.perf_counter()
        starts = M.spawn(started, RANKS, (time.time(), tensors), timeout=300)
        out[name] = {"rank_start_s": starts, "spawn_s": time.perf_counter() - t0}
        print(f"{name}: ranks started after {[round(s, 3) for s in starts]} s, spawn "
              f"returned after {out[name]['spawn_s']:.3f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
