#!/usr/bin/env python3
"""Where a work tile's time goes in the bf16 K6 (csrc/flash_attention.cu).

    python3 tools/k6_trace.py

on a machine with one NVIDIA GPU, from the repo root.  It copies the source
into ``build/k6_trace/`` with ``clock64()`` stamps added at the consumer's
phases (warp 0 of each consumer warpgroup, one CTA, its first 64 work tiles),
builds it with the flags of ``kernels/build.py``, runs it through the
kernel's own wrapper (``build.use_library``) at the trainer's layer [256,
128, 8, 4, 32] and at stablelm-3b's prefill [4, 4096, 32, 32, 80], causal
with the logsumexp, and prints one JSON line a shape: the median cycles of
each phase over the tiles after a CTA's first (whose first S runs alone):
``wait_q`` (the walk's next tile and its Q), ``wait_kv`` (its first K/V
stage), ``issue_to_S`` (its first S, with the previous tile's last P . V
behind it), ``softmax`` (that tile's first softmax), ``wait_pv`` (the rest
of that P . V), ``store_out`` (the previous tile's output), ``rest`` (its
later KV tiles), and ``tile`` (stamp to stamp), with the card's name and
power limit.  A stamp's anchor that is no longer in the source raises.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as K6  # noqa: E402

CTA = 5  # the CTA whose consumers stamp
TILES = 64
SHAPES = ((256, 128, 8, 4, 32), (4, 4096, 32, 32, 80))
PHASES = {"wait_q": (0, 1), "wait_kv": (1, 2), "issue_to_S": (2, 3), "softmax": (3, 4),
          "wait_pv": (4, 5), "store_out": (5, 6), "rest": (6, 7)}


def stamp(k: int, tile: str = "qi") -> str:
    return (f"if (blockIdx.x == {CTA} && (threadIdx.x & 127) == 0 && {tile} < {TILES}) "
            f"k6_trace[(wg * {TILES} + {tile}) * 8 + {k}] = clock64();")


def traced_source() -> str:
    src = (build.CSRC / f"{K6.NAME}.cu").read_text()
    subs = [
        ("namespace {\n\nconstexpr float kNegInf",
         f"__device__ long long k6_trace[2 * {TILES} * 8];\nnamespace {{\n\nconstexpr float kNegInf"),
        ("      if (u >= n_units) return false;\n",
         "      if (u >= n_units) return false;\n      " + stamp(0) + "\n"),
        ("      hopper::mbar_wait<true>(&qfull[qb], (qi / QB) & 1);\n"
         "      hopper::mbar_wait<true>(&full[it % ST], (it / ST) & 1);\n",
         "      hopper::mbar_wait<true>(&qfull[qb], (qi / QB) & 1);\n      " + stamp(1) + "\n"
         "      hopper::mbar_wait<true>(&full[it % ST], (it / ST) & 1);\n      " + stamp(2) + "\n"),
        ("        hopper::wgmma_wait<1>();\n        prev.m0 = m0",
         "        hopper::wgmma_wait<1>();\n        " + stamp(3) + "\n        prev.m0 = m0"),
        ("        first_s_in();\n        hopper::wgmma_wait<0>();\n        release(prev.kv);\n"
         "        store_out(prev);\n        begin_o();\n        rest();\n",
         "        first_s_in();\n        " + stamp(4) + "\n        hopper::wgmma_wait<0>();\n        "
         + stamp(5) + "\n        release(prev.kv);\n        store_out(prev);\n        " + stamp(6)
         + "\n        begin_o();\n        rest();\n        " + stamp(7, "(qi - 1)") + "\n"),
        ('}  // extern "C"',
         "int k6_trace_read(long long* out) {\n  return (int)cudaMemcpyFromSymbol(out, k6_trace, "
         'sizeof(k6_trace));\n}\n\n}  // extern "C"'),
    ]
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"k6_trace: anchor not once in {K6.NAME}.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_trace: no CUDA GPU present", file=sys.stderr)
        return 1
    out = ROOT / "build" / "k6_trace"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{K6.NAME}.cu"
    cu.write_text(traced_source())
    so = out / f"lib{K6.NAME}_trace.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
                    str(cu)], check=True)
    build.use_library(K6.NAME, so)
    lib = build.load(K6.NAME, {s: K6._ARGS for s in K6._SYMBOLS.values()})
    lib.k6_trace_read.argtypes = [ctypes.c_void_p]
    card = CS.nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, Hkv, dh in SHAPES:
        q = torch.randn((B, S, H, dh), device="cuda", generator=gen).to(torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, dh), device="cuda", generator=gen).to(torch.bfloat16)
                for _ in "kv")
        lse = torch.empty((B, H, S), device="cuda")
        buf = (ctypes.c_longlong * (2 * TILES * 8))()
        for _ in range(3):  # the last launch's stamps stay
            K6.flash_attention(q, k, v, True, lse=lse)
        torch.cuda.synchronize()
        if lib.k6_trace_read(buf):
            raise RuntimeError("k6_trace: reading the stamps failed")
        res = {}
        for wg in (0, 1):
            rows = [buf[(wg * TILES + i) * 8:(wg * TILES + i + 1) * 8] for i in range(TILES)]
            rows = [r for r in rows[1:] if r[0] and r[7]]  # the CTA's first tile has no stamps 3-7
            res[f"wg{wg}"] = {n: statistics.median(r[b] - r[a] for r in rows)
                              for n, (a, b) in PHASES.items()}
            res[f"wg{wg}"]["tile"] = statistics.median(
                rows[i + 1][0] - rows[i][0] for i in range(len(rows) - 1))
            res[f"wg{wg}"]["tiles"] = len(rows)
        print(json.dumps({"tool": "k6_trace", "card": card, "shape": [B, S, H, Hkv, dh],
                          "cta": CTA, "median_cycles": res}), flush=True)
        del q, k, v, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
