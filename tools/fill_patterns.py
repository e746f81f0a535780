#!/usr/bin/env python3
"""Time store patterns that fill K1''s output with zeros, beside ``torch.zeros``.

    python3 tools/fill_patterns.py

on a machine with one NVIDIA GPU, from the repo root.  Builds
``tools/fill_patterns.cu`` with the flags of ``kernels/build.py`` into
``build/fill_patterns/`` and times each pattern over a [1,272,000, 64] f32
output (dlrm-100m's table gradient), the bitmap of rows to skip all clear:
persistent grid-stride sweeps (all threads, or the 192 of K1''s fill warps;
with and without reading the bitmap; with its words loaded 4 or 8 steps
ahead; streamed or plain stores), words owned by blocks, one vector a
thread on a grid as large as the output, and TMA bulk stores from shared
memory, at 264, 528 and 1,056 blocks.  CUDA-event medians of 15 calls, the
L2 flushed by writing 256 MB before each, best and median of 3 rounds, with
the card's name and power limit.  None of these patterns is a kernel of the
port: they bound what K1''s fill can reach.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

ROWS, DIM = 1_272_000, 64
PATTERNS = {  # fill_pattern's `which`: (label, persistent)
    0: ("sweep, 256 threads, plain stores", True),
    1: ("sweep, 256 threads", True),
    2: ("sweep, 192 threads", True),
    3: ("sweep, 192 threads, bitmap", True),
    4: ("sweep, 192 threads, bitmap, plain stores", True),
    5: ("sweep, 192 threads, bitmap 8 steps ahead", True),
    6: ("sweep, 192 threads, bitmap 4 steps ahead", True),
    7: ("words owned by blocks, 192 threads, bitmap", True),
    8: ("one vector a thread", False),
    9: ("one vector a thread, bitmap", False),
    10: ("TMA bulk stores of 2 KB", True),
    11: ("TMA bulk stores of 8 KB", True),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("fill_patterns: no CUDA GPU present", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out_dir = ROOT / "build" / "fill_patterns"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libfill_patterns.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(ROOT / "tools" / "fill_patterns.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.fill_pattern.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty((ROWS, DIM), device="cuda")
    bitmap = torch.zeros(((ROWS + 31) // 32,), dtype=torch.int32, device="cuda")
    flush = torch.empty(256 << 18, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, reps=15):
        for _ in range(3):
            fn()
        events = []
        for _ in range(reps):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def run(which, blocks):
        code = lib.fill_pattern(which, out.data_ptr(), bitmap.data_ptr(), ROWS, blocks, stream)
        if code:
            raise RuntimeError(f"fill pattern {which}: CUDA error {code}")

    times: dict[str, list[float]] = {}
    for _ in range(3):
        for which, (label, persistent) in PATTERNS.items():
            for blocks in ((264, 528, 1056) if persistent else (0,)):
                key = f"{label}, {blocks} blocks" if persistent else label
                times.setdefault(key, []).append(ms(lambda: run(which, blocks)))
        times.setdefault("torch.zeros", []).append(
            ms(lambda: torch.zeros((ROWS, DIM), device="cuda")))
    if bool(out.any()):
        raise AssertionError("a pattern left a nonzero in the output")
    print(card)
    for key, t in times.items():
        print(f"{key:55s} best {min(t):.6f} ms, median {statistics.median(t):.6f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
