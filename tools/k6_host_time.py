#!/usr/bin/env python3
"""Host time of one bf16 call of K6 or its backward K6'
(``kernels/flash_attention.py``), by part.

    python3 tools/k6_host_time.py [--root CHECKOUT] [--backward]

on a machine with one NVIDIA GPU.  ``--root`` times the package of another
checkout (for example an older commit unpacked under ``build/``), so two
designs compare in one call on one card.  At lm-small's layer [8, 128, 8,
4, 32] causal with the row logsumexp (the trainer's forward), where the
host's enqueue outlasts the kernel, ``chip_smoke.k6_host_split`` times the
wrapper, its C launch function alone and, where the library exports
``flash_attention_bf16_host_ns``, the tensor maps and the shared-memory
attribute as a call makes them now and as every call made them before the
map cache, each over ``chip_smoke.K6_HOST_CALLS`` calls, ``REPEATS`` times.
``--backward`` splits K6''s call at the same layer the same way
(``chip_smoke.k6b_host_split``; the parts where the library exports
``flash_attention_backward_bf16_host_ns``).  One JSON line: each part's
median and every repeat in microseconds a call, with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPEATS = 5
SHAPE = (8, 128, 8, 4, 32)  # lm-small's layer: B, S, H, Hkv, dh


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--backward", action="store_true")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS  # puts this checkout's src first; --root goes before it

    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("k6_host_time: no CUDA GPU present", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    B, S, H, Hkv, dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, H, dh), device="cuda", generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, dh), device="cuda", generator=gen).to(torch.bfloat16)
            for _ in "kv")
    lse = torch.empty((B, H, S), device="cuda")
    if opts.backward:
        from repro_torch.kernels import ref

        do = torch.randn((B, S, H, dh), device="cuda", generator=gen).to(torch.bfloat16)
        o, lse = ref.flash_attention_ref(q, k, v, True, return_lse=True)
        runs = [CS.k6b_host_split(q, k, v, o, lse, do, True) for _ in range(REPEATS)]
    else:
        runs = [CS.k6_host_split(q, k, v, True, lse) for _ in range(REPEATS)]
    parts = [p for p in runs[0] if p.endswith("_us")]
    print(json.dumps({"tool": "k6_host_time", "kernel": "K6'" if opts.backward else "K6",
                      "root": str(root), "card": card,
                      "shape": list(SHAPE), "calls": runs[0]["calls"],
                      "median_us": {p: statistics.median(r[p] for r in runs) for p in parts},
                      "us": {p: [r[p] for r in runs] for p in parts}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
