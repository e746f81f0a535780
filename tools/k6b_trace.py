#!/usr/bin/env python3
"""Where a step's time goes in the one-pass design of the bf16 K6', which lost
in turns and is kept as a variant (tools/kernel_variants/k6b_onepass).

    python3 tools/k6b_trace.py [--root tools/kernel_variants/k6b_onepass]

on a machine with one NVIDIA GPU, from the repo root.  It copies that
checkout's ``csrc/flash_attention_backward.cu`` into ``build/k6b_trace/``
with ``clock64()`` stamps added at the phases of a step (thread 0 of each
consumer warpgroup, one CTA, its first ``STEPS`` steps) and of the dQ
writers, builds it with the flags of ``kernels/build.py``, runs it through
that checkout's wrapper (``build.use_library``) at the trainer's layer
[256, 128, 8, 4, 32],
stablelm-3b's training layer [2, 4096, 32, 32, 80] and olmoe-1b-7b's [1,
4096, 16, 16, 128], causal, and prints one JSON line a shape: the median
cycles of each phase over the CTA's steps.  Consumer phases: ``rows`` (the
step's lse and D in), ``load`` (its Q and dO landed), ``s`` (S^T in, with
the last step's products behind it where the loop is pipelined), ``dp``
(dP^T in: P^T formed meanwhile), ``ds`` (dS^T formed, and the last step's
products in and retired), ``meet`` (the barrier before P^T and dS go to
shared memory: the other warpgroup), ``store`` (they are stored), and
``step`` (stamp to stamp).  Writer phases: ``turn`` (waiting for its turn),
``staged`` (waiting for the consumers' dQ), ``issue`` (the add issued),
``read`` (the staging buffer read), ``added`` (the add in and the turn
passed on), and ``step`` (from one step's stamp to the next, either
writer's).  A stamp's anchor that is no longer in the source raises.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as K6  # noqa: E402

CTA = 5  # the CTA whose threads stamp
STEPS = 256
SHAPES = ((256, 128, 8, 4, 32), (2, 4096, 32, 32, 80), (1, 4096, 16, 16, 128))
CONSUMER = {"rows": (0, 1), "load": (1, 2), "s": (2, 3), "dp": (3, 4), "ds": (4, 5),
            "meet": (5, 6), "store": (6, 7)}
WRITER = {"turn": (0, 1), "staged": (1, 2), "issue": (2, 3), "read": (3, 4), "added": (4, 5)}


def stamp(row: str, k: int, step: str, who: str = "true") -> str:
    return (f"if (blockIdx.x == {CTA} && {who} && {step} < {STEPS}) "
            f"k6b_trace[({row} * {STEPS} + {step}) * 8 + {k}] = clock64();")


def traced_source(root: Path) -> str:
    src = (root / "src/repro_torch/csrc" / f"{K6.NAME_BWD}.cu").read_text()
    step = "(gs + it)"
    subs = [
        ("namespace {\n\nusing tensor_map::kEncodeError;",
         f"__device__ long long k6b_trace[4 * {STEPS} * 8];\n"
         "namespace {\n\nusing tensor_map::kEncodeError;"),
        ("      if (tid < QS) {\n        rows_wg[(it & 1) * 2 * QS + tid] = next_l * kLog2eBwd;",
         "      " + stamp("W", 0, step, "tid == 0") + "\n      if (tid < QS) {\n"
         "        rows_wg[(it & 1) * 2 * QS + tid] = next_l * kLog2eBwd;"),
        ("      hopper::named_barrier_sync(1 + W, 128);  // step it's rows are in\n",
         "      hopper::named_barrier_sync(1 + W, 128);  // step it's rows are in\n      "
         + stamp("W", 1, step, "tid == 0") + "\n"),
        ("      hopper::mbar_wait<true>(&full[s], ((gs + it) / Sm::kStages) & 1);\n",
         "      hopper::mbar_wait<true>(&full[s], ((gs + it) / Sm::kStages) & 1);\n      "
         + stamp("W", 2, step, "tid == 0") + "\n"),
        ("      hopper::wgmma_wait<K + 1>();\n      hopper::fence_regs(sc);\n",
         "      hopper::wgmma_wait<K + 1>();\n      hopper::fence_regs(sc);\n      "
         + stamp("W", 3, step, "tid == 0") + "\n"),
        ("      hopper::wgmma_wait<K>();\n      hopper::fence_regs(dp);\n",
         "      hopper::wgmma_wait<K>();\n      hopper::fence_regs(dp);\n      "
         + stamp("W", 4, step, "tid == 0") + "\n"),
        ("      hopper::named_barrier_sync(3, 2 * 128);",
         "      " + stamp("W", 5, step, "tid == 0")
         + "\n      hopper::named_barrier_sync(3, 2 * 128);\n      "
         + stamp("W", 6, step, "tid == 0")),
        ("      hopper::named_barrier_sync(4, 2 * 128);  // all of dS is in\n",
         "      hopper::named_barrier_sync(4, 2 * 128);  // all of dS is in\n      "
         + stamp("W", 7, step, "tid == 0") + "\n"),
        ("          uint32_t* turn = a.turns + blk;\n",
         "          uint32_t* turn = a.turns + blk;\n          " + stamp("2", 0, "dq_n") + "\n"),
        ("          hopper::mbar_wait<true>(&dq_full[w], (dq_n / Sm::kDqBufs) & 1);\n",
         "          " + stamp("2", 1, "dq_n") + "\n"
         "          hopper::mbar_wait<true>(&dq_full[w], (dq_n / Sm::kDqBufs) & 1);\n"
         "          " + stamp("2", 2, "dq_n") + "\n"),
        ("          hopper::bulk_commit();\n",
         "          hopper::bulk_commit();\n          " + stamp("2", 3, "dq_n") + "\n"),
        ("          hopper::mbar_arrive(&dq_empty[w]);\n",
         "          hopper::mbar_arrive(&dq_empty[w]);\n          " + stamp("2", 4, "dq_n") + "\n"),
        ("          hopper::st_release_gpu(turn, (uint32_t)pos + 1);\n",
         "          hopper::st_release_gpu(turn, (uint32_t)pos + 1);\n          "
         + stamp("2", 5, "dq_n") + "\n"),
        ('}  // extern "C"',
         "int k6b_trace_read(long long* out) {\n  return (int)cudaMemcpyFromSymbol(out, k6b_trace, "
         "sizeof(k6b_trace));\n}\n\nint k6b_trace_clear(const long long* zeros) {\n"
         "  return (int)cudaMemcpyToSymbol(k6b_trace, zeros, sizeof(k6b_trace));\n}\n\n"
         '}  // extern "C"'),
    ]
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"k6b_trace: anchor not once in {K6.NAME_BWD}.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def phases(rows: list, names: dict, last: int) -> dict:
    rows = [r for r in rows if r[0] and r[last]]
    out = {n: statistics.median(r[b] - r[a] for r in rows) for n, (a, b) in names.items()}
    out["step"] = statistics.median(rows[i + 1][0] - rows[i][0] for i in range(len(rows) - 1))
    out["steps"] = len(rows)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT / "tools/kernel_variants/k6b_onepass"))
    root = Path(ap.parse_args().root).resolve()
    if not torch.cuda.is_available():
        print("k6b_trace: no CUDA GPU present", file=sys.stderr)
        return 1
    out = ROOT / "build" / "k6b_trace"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{K6.NAME_BWD}.cu"
    cu.write_text(traced_source(root))
    so = out / f"lib{K6.NAME_BWD}_trace.so"
    csrc = root / "src/repro_torch/csrc"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so), str(cu)],
                   check=True)
    # that checkout's wrapper function, which sizes its design's scratch
    spec = importlib.util.spec_from_file_location(
        "k6b_trace_wrapper", root / "src/repro_torch/kernels/flash_attention.py")
    wrapper = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = wrapper
    spec.loader.exec_module(wrapper)
    backward = wrapper.flash_attention_backward
    build.use_library(K6.NAME_BWD, so)
    lib = build.load(K6.NAME_BWD, {s: K6._ARGS_BWD for s in K6._SYMBOLS_BWD.values()})
    lib.k6b_trace_read.argtypes = [ctypes.c_void_p]
    lib.k6b_trace_clear.argtypes = [ctypes.c_void_p]
    card = CS.nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, Hkv, dh in SHAPES:
        q, do = (torch.randn((B, S, H, dh), device="cuda", generator=gen).to(torch.bfloat16)
                 for _ in "qd")
        k, v = (torch.randn((B, S, Hkv, dh), device="cuda", generator=gen).to(torch.bfloat16)
                for _ in "kv")
        o, lse = ref.flash_attention_ref(q, k, v, True, return_lse=True)
        buf = (ctypes.c_longlong * (4 * STEPS * 8))()
        backward(q, k, v, o, lse, do, True)  # built and warm
        torch.cuda.synchronize()
        if lib.k6b_trace_clear(buf):
            raise RuntimeError("k6b_trace: clearing the stamps failed")
        backward(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        if lib.k6b_trace_read(buf):
            raise RuntimeError("k6b_trace: reading the stamps failed")

        def rows_of(r):
            return [buf[(r * STEPS + i) * 8:(r * STEPS + i + 1) * 8] for i in range(STEPS)]

        res = {f"wg{w}": phases(rows_of(w), CONSUMER, 7) for w in (0, 1)}
        if any(r[0] for r in rows_of(2)):
            res["writers"] = phases(rows_of(2), WRITER, 5)
        print(json.dumps({"tool": "k6b_trace", "root": str(root), "card": card,
                          "shape": [B, S, H, Hkv, dh],
                          "cta": CTA, "median_cycles": res}), flush=True)
        del q, k, v, o, lse, do
    return 0


if __name__ == "__main__":
    sys.exit(main())
