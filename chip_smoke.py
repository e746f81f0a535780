#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Phases, each printed as it runs; any failure raises and exits nonzero:
  1. device   — torch's device name and nvidia-smi's name and power limit;
  2. build    — nvcc builds kernels K1 (embedding bag) and K2 (dot
                interaction) from src/repro_torch/csrc/, in parallel;
  3. kernels  — each kernel against its plain PyTorch version on the card, at
                the main path's shapes, in f32 and bf16 (TF32 off); CUDA-event
                medians of the kernel, its plain version and one PyTorch call
                computing the same function, beside the bound from bytes and
                operations;
  4. forward  — ``R.forward`` of dlrm-flexemr at its published config
                (26 fields x 64, 150M-row f32 table made on the card) on
                2048 synthetic requests: finite scores, allclose to the plain
                forward, K1 and K2 launched;
  5. serve    — ``repro_torch.launch.serve.run`` with its defaults (8 servers,
                pooled engine, depth 2, closed loop) on 400 requests: every
                request retired, finite scores, K2 launched once per batch;
  6. the ``{"kernels": [...]}`` line, then as the last line
     ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It imports nothing of the JAX package.  Without a GPU, or without the repo's
``src/`` beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
FORWARD_BATCH = 2048
SERVE_REQUESTS = 400
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: every timed launch starts cold


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, flush: torch.Tensor, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(name: str, got, want, rtol: float, atol: float) -> float:
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
    log(f"  {name}: ok, max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU present", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs.dlrm_flexemr import make_config
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import dot_interaction as K2
    from repro_torch.kernels import embedding_bag as K1
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import recsys as R
    from repro_torch.utils import tree_to

    dev = torch.device(DEVICE)
    # ---------------------------------------------------------------- device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch: {kind} (count {torch.cuda.device_count()}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN: f32 products run in full f32")

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    report = build.build([K1.NAME, K2.NAME], ptxas_verbose=True)
    log(f"[build] {time.perf_counter() - t0:.2f}s wall for "
        + ", ".join(f"{n} {r['seconds']:.2f}s" for n, r in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line:
                log(f"  {name}: {line.strip()}")

    # ------------------------------------------- main-path model and inputs
    cfg = make_config()
    t0 = time.perf_counter()
    params = R.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    table = params["emb"]["table"]
    log(f"[forward] dlrm-flexemr table {tuple(table.shape)} f32 "
        f"({table.numel() * 4 / 1e9:.1f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    host = syn.recsys_batch(rng, cfg.tables, FORWARD_BATCH, n_dense=cfg.n_dense)
    batch = {k: torch.from_numpy(host[k]).to(dev) for k in ("indices", "mask", "dense")}
    emb = cfg.embedding()
    # K1's inputs exactly as DisaggEmbedding.lookup hands them to the kernel.
    fused = emb._fused_rows(emb.sharded, batch["indices"]).clamp_(0, table.shape[0] - 1)
    ids = fused.reshape(-1).contiguous()
    wts = batch["mask"].reshape(-1).to(torch.float32).contiguous()
    n_bags = FORWARD_BATCH * cfg.num_fields
    nnz = ids.numel() // n_bags
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    # --------------------------------------------------------------- kernels
    log("[kernels] each kernel against its plain version on the card")
    k1_out = K1.embedding_bag(table, ids, wts, n_bags)
    k1_err = assert_close(f"K1 embedding_bag f32 [{n_bags} bags x {nnz}, D={table.shape[1]}]",
                          k1_out, ref.embedding_bag_ref(table, ids, wts, n_bags), 1e-5, 1e-5)
    small = torch.empty((1 << 20, 64), dtype=torch.bfloat16, device=dev).normal_(
        0, 0.01, generator=torch.Generator(device=dev).manual_seed(1))
    ids_small = (ids % small.shape[0]).to(torch.int32)
    assert_close("K1 embedding_bag bf16 [1M-row table, same bags]",
                 K1.embedding_bag(small, ids_small, wts, n_bags),
                 ref.embedding_bag_ref(small, ids_small, wts, n_bags), 1e-5, 1e-5)
    del small
    gen = torch.Generator(device=dev).manual_seed(2)
    x_fwd = torch.randn((FORWARD_BATCH, cfg.num_fields + 1, cfg.embed_dim),
                        device=dev, generator=gen)
    k2_err = assert_close(f"K2 dot_interaction f32 {list(x_fwd.shape)}",
                          K2.dot_interaction(x_fwd), ref.dot_interaction_ref(x_fwd), 1e-4, 1e-4)
    x_bf = x_fwd.to(torch.bfloat16)
    assert_close(f"K2 dot_interaction bf16 {list(x_bf.shape)}",
                 K2.dot_interaction(x_bf), ref.dot_interaction_ref(x_bf), 1e-4, 1e-4)
    x_srv = torch.randn((64, 17, 64), device=dev, generator=gen)
    assert_close(f"K2 dot_interaction f32 {list(x_srv.shape)} (serve bucket)",
                 K2.dot_interaction(x_srv), ref.dot_interaction_ref(x_srv), 1e-4, 1e-4)
    x_big = torch.randn((3, 40, 512), device=dev, generator=gen)
    assert_close(f"K2 dot_interaction f32 {list(x_big.shape)} (one sample > 48 KB shared)",
                 K2.dot_interaction(x_big), ref.dot_interaction_ref(x_big), 1e-4, 1e-4)

    D = table.shape[1]
    live = ids[wts != 0]
    k1_bytes = (torch.unique(live).numel() * D * 4  # rows the bags need, once
                + ids.numel() * 8  # ids + weights
                + n_bags * D * 4)  # pooled output
    k1_bound, k1_by = bound(k1_bytes, 2 * live.numel() * D)
    B, Fx, Dx = x_fwd.shape
    k2_bound, k2_by = bound(B * Fx * Dx * 4 + B * Fx * Fx * 4, 2 * B * Fx * Fx * Dx)
    ids_2d = ids.view(n_bags, nnz)
    timings = {
        "embedding_bag": (
            cuda_ms(lambda: K1.embedding_bag(table, ids, wts, n_bags), flush),
            cuda_ms(lambda: ref.embedding_bag_ref(table, ids, wts, n_bags), flush),
            cuda_ms(lambda: F.embedding_bag(ids_2d, table, mode="sum",
                                            per_sample_weights=wts.view(n_bags, nnz)),
                    flush),
        ),
        "dot_interaction": (
            cuda_ms(lambda: K2.dot_interaction(x_fwd), flush),
            cuda_ms(lambda: ref.dot_interaction_ref(x_fwd), flush),
            cuda_ms(lambda: torch.bmm(x_fwd, x_fwd.transpose(1, 2)), flush),
        ),
    }
    for name, (ms, plain_ms, lib_ms), (bms, by) in zip(
            timings, timings.values(), ((k1_bound, k1_by), (k2_bound, k2_by))):
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bms:.4f} ms (by {by}; the "
            f"kernel reaches {bms / ms:.1%} of it)")
    log(f"  bounds: K1 moves {k1_bytes / 1e6:.2f} MB ({torch.unique(live).numel()} "
        f"unique live rows of {ids.numel()} slots); K2 moves "
        f"{(B * Fx * Dx + B * Fx * Fx) * 4 / 1e6:.2f} MB")
    del x_fwd, x_bf, x_srv, x_big, k1_out

    # --------------------------------------------------------------- forward
    K1.launches = K2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        scores = R.forward(cfg, params, batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = {"embedding_bag": K1.launches, "dot_interaction": K2.launches}
    if min(fwd_launches.values()) < 1:
        raise AssertionError(f"forward did not launch every kernel: {fwd_launches}")
    if scores.shape != (FORWARD_BATCH,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"forward scores not finite [{FORWARD_BATCH}]: {scores.shape}")
    with torch.no_grad():
        pooled_plain = emb.lookup_reference(params["emb"], batch["indices"], batch["mask"])
        pooled = emb.lookup(params["emb"], batch["indices"], batch["mask"])
        dense_cpu = tree_to({k: v for k, v in params.items() if k != "emb"}, "cpu")
        # Plain forward: the plain gather + pool on the card, the dense stage
        # on the CPU, where every wrapper takes its plain version.
        scores_plain = R.dense_forward(cfg, dense_cpu, pooled_plain.cpu(),
                                       batch["dense"].cpu())
    assert_close("forward pooled [2048, 26, 64] vs lookup_reference", pooled, pooled_plain,
                 1e-5, 1e-5)
    assert_close("forward scores [2048] vs plain forward", scores.cpu(), scores_plain,
                 1e-4, 1e-5)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: R.forward(cfg, params, batch), flush)
    log(f"[forward] first call {fwd_s * 1e3:.2f} ms wall, then {fwd_ms:.4f} ms "
        f"device median (L2 cold); launches in the first call {fwd_launches}")
    del params, table, batch, fused, ids, wts, ids_2d, live, pooled, pooled_plain, scores
    del flush
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- serve
    args = launch_serve.parse_args(["--requests", str(SERVE_REQUESTS)])
    K1.launches = K2.launches = 0
    out = launch_serve.run(args)
    srv_launches = {"embedding_bag": K1.launches, "dot_interaction": K2.launches}
    if not out["requests"] == out["submitted"] == SERVE_REQUESTS:
        raise AssertionError(f"served {out['requests']} of {out['submitted']} "
                             f"(wanted {SERVE_REQUESTS})")
    if out["nonfinite_scores"]:
        raise AssertionError(f"{out['nonfinite_scores']} non-finite serve scores")
    if srv_launches["dot_interaction"] < out["batches"]:
        raise AssertionError(f"K2 launched {srv_launches['dot_interaction']} times "
                             f"for {out['batches']} batches")
    log("[serve] " + json.dumps({
        "device": out["device"], "requests": out["requests"], "batches": out["batches"],
        "throughput_rps": out["throughput_rps"], "p50_latency_ms": out["p50_latency_ms"],
        "p99_latency_ms": out["p99_latency_ms"], "dense_seconds": out["dense_seconds"],
        "dense_ms_per_batch": 1e3 * out["dense_seconds"] / out["batches"],
        "lookup_seconds": out["lookup_seconds"], "hit_rate": out["hit_rate"],
        "launches": srv_launches,
    }))

    # ---------------------------------------------------------- kernels line
    meta = {
        "embedding_bag": (K1, "src/repro/kernels/embedding_bag.py:38", k1_err,
                          k1_bound, k1_by),
        "dot_interaction": (K2, "src/repro/kernels/dot_interaction.py:28", k2_err,
                            k2_bound, k2_by),
    }
    kernels = []
    for name, (mod, replaces, err, bms, by) in meta.items():
        ms, plain_ms, lib_ms = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{mod.NAME}.cu",
            "replaces": replaces,
            "launches": fwd_launches[name] + srv_launches[name],
            "launches_by_path": {"forward": fwd_launches[name], "serve": srv_launches[name]},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms, "ok": True,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
