#!/usr/bin/env python3
"""K6 f32 and K6' once each at phase 9g's f32 shapes: a run for compute-sanitizer.

    compute-sanitizer --tool racecheck python3 tools/k6_sanitize.py [--root DIR] [--kernels ...]
    compute-sanitizer --tool synccheck python3 tools/k6_sanitize.py ...
    python3 tools/k6_sanitize.py ...          (the same checks, no sanitizer)

on a machine with one NVIDIA GPU, from the repo root.  It builds K6 and K6'
(``csrc/flash_attention.cu``, ``csrc/flash_attention_backward.cu``) of the
checkout at ``--root`` (default: this one; an older commit unpacked under
``build/`` runs its own kernels and wrappers) and, at every f32 case of
``chip_smoke.LMT_KERNEL_CASES``, on inputs made from one seed, calls each
kernel of ``--kernels`` once:

* ``k6``: K6 f32 without and with its row logsumexp, held against the plain
  version at ``chip_smoke.LM_F32_TOL``;
* ``k6b_f32``: K6' f32, at ``LM_F32_TOL``, and once more, bit-equal;
* ``k6b_bf16``: K6' bf16 on the same shapes where bf16 takes the head dim
  (64-128), the inputs rounded to bf16, as phase 9g holds it
  (``assert_close_rows`` with the head floor ``K6B_FLOOR``).

Each call is synchronised before its check, so a fault shows at the kernel
that made it.  ``--repeat N`` runs each kernel N times more on the same
inputs, every output bit-equal to the first: a probe for races where the
sanitizer does not run (it can refuse the device, PERF.md).  It prints a line a check, the process's TF32 state
(``torch.backends.cuda.matmul.allow_tf32``, ``torch.backends.cudnn.allow_tf32``,
``torch.get_float32_matmul_precision()`` and the environment's
``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE`` and ``NVIDIA_TF32_OVERRIDE``) and the
card's name and power limit, and exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts this checkout's src/ on the path)

KERNELS = ("k6", "k6b_f32", "k6b_bf16")


def tf32_state() -> dict:
    import torch

    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            **{v: os.environ.get(v) for v in ("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE",
                                              "NVIDIA_TF32_OVERRIDE")}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--repeat", type=int, default=0)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if set(kernels) - set(KERNELS):
        ap.error(f"--kernels takes {KERNELS}")
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("k6_sanitize: no CUDA GPU present", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as K6

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[k6_sanitize] package {Path(K6.__file__).resolve()}", flush=True)
    build.build([K6.NAME, K6.NAME_BWD])
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    failed = []

    def repeat(name, fn, first):
        """fn() args.repeat times, each bit-equal to ``first`` (a tuple)."""
        for i in range(args.repeat):
            again = fn()
            if not all(torch.equal(a, c) for a, c in zip(first, again)):
                raise AssertionError(f"{name}: run {i + 2} differs from the first")
        if args.repeat:
            print(f"  {name}: {args.repeat + 1} runs bit-equal", flush=True)
    for label, (B, S, H, Hkv, dh, dt, causal, _) in CS.LMT_KERNEL_CASES.items():
        if dt != "f32":
            continue
        q = torch.randn((B, S, H, dh), device="cuda", generator=gen)
        k, v = (torch.randn((B, S, Hkv, dh), device="cuda", generator=gen) for _ in "kv")
        do = torch.randn((B, S, H, dh), device="cuda", generator=gen)
        shape = f"{label} [{B}, {S}, {H}, {Hkv}, {dh}] {'causal' if causal else 'full'}"
        o, lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
        try:
            if "k6" in kernels:
                got = K6.flash_attention(q, k, v, causal)
                torch.cuda.synchronize()
                CS.assert_close(f"K6 f32 {shape}", got, o, *CS.LM_F32_TOL)
                lse_k = torch.empty((B, H, S), dtype=f32, device="cuda")
                got = K6.flash_attention(q, k, v, causal, lse=lse_k)
                torch.cuda.synchronize()
                CS.assert_close(f"K6 f32 with lse {shape}", got, o, *CS.LM_F32_TOL)
                CS.assert_close(f"K6 f32 with lse {shape}: lse", lse_k, lse, *CS.LM_F32_TOL)
                repeat(f"K6 f32 {shape}", lambda: (K6.flash_attention(q, k, v, causal),),
                       (K6.flash_attention(q, k, v, causal),))

                def with_lse():
                    out = torch.empty_like(lse_k)
                    return K6.flash_attention(q, k, v, causal, lse=out), out

                repeat(f"K6 f32 with lse {shape}", with_lse, (got, lse_k))
            if "k6b_f32" in kernels:
                want = ref.flash_attention_backward_ref(q, k, v, o, lse, do, causal)
                got = K6.flash_attention_backward(q, k, v, o, lse, do, causal)
                torch.cuda.synchronize()
                for n, g, w in zip(("dq", "dk", "dv"), got, want):
                    CS.assert_close(f"K6' f32 {shape}: {n}", g, w, *CS.LM_F32_TOL)
                again = K6.flash_attention_backward(q, k, v, o, lse, do, causal)
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    raise AssertionError(f"K6' f32 {shape}: two launches differ")
                print(f"  K6' f32 {shape}: two launches bit-equal", flush=True)
                repeat(f"K6' f32 {shape}",
                       lambda: K6.flash_attention_backward(q, k, v, o, lse, do, causal), got)
            if "k6b_bf16" in kernels and dh >= 64:
                qb, kb, vb, gb = (t.to(bf16) for t in (q, k, v, do))
                ob, lseb = ref.flash_attention_ref(qb, kb, vb, causal, return_lse=True)
                want = ref.flash_attention_backward_ref(qb, kb, vb, ob, lseb, gb, causal)
                got = K6.flash_attention_backward(qb, kb, vb, ob, lseb, gb, causal)
                torch.cuda.synchronize()
                for n, g, w in zip(("dq", "dk", "dv"), got, want):
                    CS.assert_close_rows(f"K6' bf16 {shape}: {n}", g, w, *CS.LM_BF16_TOL,
                                         CS.K6B_FLOOR)
                repeat(f"K6' bf16 {shape}",
                       lambda: K6.flash_attention_backward(qb, kb, vb, ob, lseb, gb, causal), got)
        except AssertionError as e:
            print(f"  FAILED: {e}", flush=True)
            failed.append(label)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[k6_sanitize] TF32 state: {tf32_state()}", flush=True)
    print(f"[k6_sanitize] {card}; {'failed: ' + ', '.join(failed) if failed else 'all checks passed'}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
