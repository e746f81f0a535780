#!/usr/bin/env python3
"""Host time of one call of the K7 wrapper (``kernels/flash_decode.py``).

    python3 tools/k7_host_time.py [--root CHECKOUT]

on a machine with one NVIDIA GPU.  ``--root`` times the package of another
checkout (for example an older commit unpacked under ``build/``), so two
designs compare in one call on one card.  At the decode path's shapes (q
[4, 32, 80] against caches [4, 4128, 32, 80], bf16) with cache_len 1, so
that the card keeps up with the host and no launch waits for a free slot,
it times ``CALLS`` unsynchronised calls by ``time.perf_counter``, after a
warm-up, ``REPEATS`` times, and prints one JSON line: the median and every
repeat's microseconds per call, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = 1000
REPEATS = 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("k7_host_time: no CUDA GPU present", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_decode as K7

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 32, 80), device="cuda", generator=gen).to(torch.bfloat16)
    kc, vc = (torch.randn((4, 4128, 32, 80), device="cuda", generator=gen)
              .to(torch.bfloat16) for _ in range(2))
    n_t = torch.tensor(1, dtype=torch.int32, device="cuda")
    us = []
    for _ in range(REPEATS):
        for _ in range(50):
            K7.flash_decode(q, kc, vc, n_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            K7.flash_decode(q, kc, vc, n_t)
        us.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({"tool": "k7_host_time", "root": str(root), "card": card,
                      "calls": CALLS, "host_us_per_call_median": statistics.median(us),
                      "host_us_per_call": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
