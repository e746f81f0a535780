#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Phases, each printed as it runs; any failure raises and exits nonzero:
  1. device   — torch's device name and nvidia-smi's name and power limit;
  2. build    — nvcc builds kernels K1 (embedding bag), K2 (dot interaction),
                K3 (hot-cache probe + gather + pool), K4 (swap-in scatter),
                K5 (top-k neighbor select), K6 (flash attention) and K7
                (flash decode) from src/repro_torch/csrc/, one nvcc per
                source, all in parallel, and prints each kernel's -Xptxas -v
                registers, spills and performance warnings;
  3. kernels  — each kernel against its plain PyTorch version on the card, at
                the main paths' shapes (TF32 off): K1 in its masked and
                weighted modes, f32 and bf16, with NaN in the rows behind
                zero-weight slots (masked: finite; weighted: NaN where the
                plain version has it), and at nnz 1, 3, 4, 8, 1003 bags,
                ids outside [0, V), D 17 and 256; K1/K2 in f32 and bf16 (K2
                also at every serve bucket [32..1024, 17, 64] and at
                [3, 40, 512], and timed at the buckets beside torch.bmm); K3
                on dlrm-flexemr's 2048-request batch over a 2^18-slot cache,
                f32 and bf16 rows, and at nnz 1, 3, 4, 8, 1003 bags, caches
                of 1, 4 and 1024 slots, ids cold, negative and past every
                row, D 17; K4 at the cache build's writes and with
                repeated slots, into f32 and bf16 rows, with slots outside
                [0, C) mixed in, with one write, from bf16 rows and at a
                width of 17 (the element-wise copy); K5 in f32 and f64,
                bit for bit, on scores with ties, -inf, NaN, -0.0 and
                +0.0, all-NaN and all -inf rows, at the miner's [64, 16],
                [2048, 16], the TPU-shaped [4096, 128] and L 1, 15, 16, 17,
                31, 32, 33, 128 with k 1 and L.  CUDA-event medians of the kernel, its plain
                version and one PyTorch call computing the same function
                (none for K3), beside the bound from bytes and operations
                (K1's masked bound counts the live slots' rows, its
                weighted bound every slot's);
  4. forward  — ``R.forward`` of dlrm-flexemr at its published config
                (26 fields x 64, 150M-row f32 table made on the card) on
                2048 synthetic requests: finite scores, allclose to the plain
                forward, K1 (every launch in its masked mode) and K2 launched;
  4b. cached_forward — the same model with a 2^18-slot ``HashCacheState``:
                built by ``make_hash_cache_from_table`` from the hot ids of 4
                warm-up batches (K4), ``R.forward(..., cache=...)`` on the
                phase-4 batch (K3, K1 masked, K2) allclose to the uncached forward,
                one refresh (``cache_insert`` threshold 2 + ``decay_freq``,
                K4 again) and a second forward; then device medians of the
                cached and uncached forward, timed in turns, and each one's
                device busy time and kernels in a profiled window;
  5. serve    — ``repro_torch.launch.serve.run`` with its defaults (8 servers,
                pooled engine, depth 2, closed loop) on 400 requests: every
                request retired, finite scores, K2 launched once per batch;
  5b. serve_prefetch — a ``FlexEMRServer`` built as ``launch.serve.run``
                builds it, plus a ``PrefetchEngine`` whose miner selects on
                the card (K5), on 400 requests of co-occurrence traffic: every
                request retired, finite scores, rows prefetched, K5 launched;
  5c. serve_open_loop — ``launch.serve.run`` with ``--arrival poisson`` at half
                of phase 5's measured rate for 2 s: every arrival retired or
                shed, finite scores, K2 launched once per batch; offered and
                achieved rate, p50/p99, the driver's lag, the SLO summary;
  5d. serve_chaos — launch.serve's server on dlrm-serve over one bucket of 64,
                12 batches pre-filled from seed 0, driven by explicit admits
                and retires, fault-free and then under a kill-engine,
                drop-and-restore-shard, straggler-storm (x8) and reshard
                8 -> 16 schedule: scores bit-equal batch by batch, every
                fault fired once and recovered, the reshard's moved rows
                equal to ``reshard_tables``' count on the host, and a second
                run of the schedule with the same firing log;
  5e. serve_reshard — ``launch.serve.run --chaos-seed 0 --reshard-to 12`` on
                400 requests: every request retired with a finite score and
                the reshard to 12 in ``out["chaos"]``;
  6. lm_kernels — after the DLRM state is freed: K6 against its plain
                version at stablelm-3b's prefill layer [4, 4096, 32, 32, 80]
                causal in bf16 and f32, at lm_f32's [2, 1024, 32, 32, 80]
                causal in f32, at qwen2-72b's GQA heads
                [1, 4096, 64, 8, 128], at dh 128 without GQA
                [1, 4096, 32, 32, 128], at a ragged S (bf16 causal at dh
                64, 80 and 96, bf16 full), the same in f32 (3xTF32) and f32
                at a ragged S causal at dh 64, 80, 96 and full at 128;
                K7 at the decode
                path's caches [4, 4128, 32, 80] with NaN past cache_len
                4097, at cache_len 1, in f32 and with GQA, and at g = 4
                (q [2, 32, 128], 8 KV heads) with cache_len on an edge of
                the kernel's split over S, one past it and the whole cache;
                bf16 to two output ulps plus 2^-5 of the row's RMS, a check
                shown to refuse planted faults (one KV tile of 64 skipped,
                bf16 and f32; K7's middle chunk dropped).
                CUDA-event medians of each kernel, its plain version and
                ``F.scaled_dot_product_attention`` (timed only, never called
                by the port), and of kernel and library at the repo's own
                lengths (prefill_32k at B = 1, decode_32k at B = 8);
  7. lm_prefill — stablelm-3b at full width and depth (bf16 weights made on
                the card from seed 0), ``transformer.prefill`` of 4 prompts
                of 4,096 tokens: finite last logits, K6 launched once per
                layer; wall time of the first call, device median, tokens/s,
                and the kernels' device time in one profiled call;
  8. lm_decode — the caches padded to 4,128 positions, 32 greedy
                ``decode_step``s (argmax fed back, ``pos`` on the card, no
                host sync in the loop): finite logits, K7 launched 32 x 32
                times; per-step wall median (CUDA events around each step
                measure the host's enqueue pace: the device runs ahead of
                it), tokens/s, and the device's busy time and the kernels'
                time per step over two profiled steps;
  9. lm_checks — in f32 compute on the card, TF32 off: a 2-layer cut of the
                same weights (prefill 256, 4 decode steps) against the same
                on the CPU (plain versions), and the full depth (prefill
                1,024, 4 decode steps) against one ``forward`` over all
                1,028 tokens; the card's half is the ``lm_f32`` path, which
                must launch K6 (in f32 only) and K7;
 10. the ``{"kernels": [...]}`` line (K1's entry adds its weighted mode's
     times and bound, K6's its f32 times at lm_f32's shape and at
     lm_prefill's, each with the 3xTF32 bound and the f32 FMA one, and its
     f32 launches), then
     as the last line
     ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Each path (4, 4b, 5, 5b, 5c, 5d's run under faults, 5e, 7, 8, and 9 as
``lm_f32``: K6 and K7 in f32 on the card) runs with the launch counts set
to 0 just before it and read just after; comparisons and timings run
outside those windows.
It imports nothing of the JAX package.  Without a GPU, or without the repo's
``src/`` beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
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
BF16_TENSOR_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_TENSOR_FLOP_PER_S = 495e12  # H100 SXM tf32 tensor cores, dense (K6 f32 runs 3 products)
FORWARD_BATCH = 2048
SERVE_BUCKETS = (32, 64, 128, 256, 512, 1024)  # data/pipeline.BucketBatcher's defaults
SERVE_FIELDS = 17  # dlrm-serve's 16 fields + the bottom MLP's output
SERVE_REQUESTS = 400
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: every timed launch starts cold
HOT_SLOTS = 1 << 18  # the cached forward's hash cache (67 MB of f32 rows)
MAX_PROBES = 8
WARMUP_BATCHES = 4
MINER_ROWS = 64  # K5's timed shape: about one cache plan's triggers
K5_EDGE_WIDTHS = (1, 15, 16, 17, 31, 32, 33, 128)
FORWARD_TURNS = 6  # cached/uncached forward timing pairs, alternating order
PREFETCH_CACHE_ROWS = 256  # the serve_prefetch controller's row cap
PREFETCH_REFRESH_EVERY = 4  # batches between cache plans
PREFETCH_BURST = 8  # requests submitted between serving steps
OPEN_LOOP_SECONDS = 2  # serve_open_loop's --duration; --qps is half of serve's rate
CHAOS_BUCKET = 64  # serve_chaos's one batcher bucket
CHAOS_BATCHES = 12  # batches pre-filled for each serve_chaos run
CHAOS_SHARDS = 8  # launch.serve's --num-servers default
CHAOS_RESHARD_TO = 16
CHAOS_WAIT_S = 5.0  # batcher deadline: a pre-filled queue always gives full buckets
CHAOS_WATCHDOG_S = 10.0  # ChaosInjector's retire watchdog (raises after 2x this)
RESHARD_TO = 12  # serve_reshard's --reshard-to
LM_BATCH = 4  # prompts of the lm_prefill / lm_decode paths
LM_PROMPT = 4096  # tokens per prompt
LM_DECODE_STEPS = 32
LM_CACHE = 4128  # decode cache positions: the prompt + 32, padded
LM_CUT_LAYERS = 2  # the f32 check of the card path against the CPU path
LM_CUT_PROMPT = 256
LM_DEPTH_PROMPT = 1024  # the f32 check of decode against forward, full depth
LM_CHECK_STEPS = 4
LM_LONG_DECODE_BATCH = 8  # decode_32k's batch of 128 cut to one card (LM_SHAPES)
LM_GQA_HEADS = (64, 8, 128)  # qwen2-72b's query heads, KV heads, head dim
LM_RAGGED_SEQ = 1037  # no multiple of a 64-row tile
# K6/K7 against their plain versions.  f32: rtol = atol = 2e-5, the
# reference's.  bf16, by ``assert_close_rows``: rtol 2^-6 (two output ulps)
# plus 2^-5 of the RMS of the element's row (its head's dh values), for the
# probabilities that kernel and plain version round to bf16 at different
# points.  A fixed atol cannot do: |out| falls as 1/sqrt(keys), to about
# 0.02 at 4,096 keys, so an atol that covers a 4-key row would accept a
# kernel that skips a KV tile of a long row (phase 6 checks that this one
# does not).
LM_F32_TOL = (2e-5, 2e-5)
LM_BF16_TOL = (1.6e-2, 3.2e-2)
LM_KV_TILE = 64  # the KV tile of the planted faults


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, flush: torch.Tensor, reps: int = 15, warmup: int = 3,
            read_flush: bool = False) -> float:
    """Median device time of one call of ``fn``, L2 flushed before each by
    writing ``flush`` (which leaves up to the L2's 50 MB of dirty lines for
    ``fn`` to write back) or, with ``read_flush``, by reading it (clean)."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        if read_flush:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(bytes_moved: float, flops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_busy(fn, calls: int) -> dict:
    """Run ``fn`` ``calls`` times under ``torch.profiler``: the device time
    its kernels took (summed; one stream, so they do not overlap), how many
    kernels and copies ran, and the kernels with the most of the time.
    ``device_busy_ms`` is None when the trace holds no device events.  The
    profiler slows the host, so the window's own wall time is not reported;
    compare with an unprofiled run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            n_ops += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"calls": calls,
            "device_busy_ms": sum(by_name.values()) / calls if by_name else None,
            "device_ops_per_call": n_ops / calls,
            "top_kernels_ms_per_call": [[n[:70], ms / calls] for n, ms in top]}


def kernel_name(mangled: str) -> str:
    """``flash_decode_kernel<bf16, 80, 1>`` from a mangled entry-function
    name: the kernel and its type and integer template arguments."""
    for m in re.finditer(r"_kernelI", mangled):  # <length><name>I<args>E
        end = m.start() + len("_kernel")
        n = next((n for n in range(1, end) if mangled[:end - n].endswith(str(n))), 0)
        name, rest = mangled[end - n:end], mangled[end:]
        if n:
            args, rest = [], rest[1:]
            for tok, label in ((r"13__nv_bfloat16", "bf16"), (r"f", "f32"), (r"d", "f64"),
                               (r"S\d*_", "S_"), (r"Li(\d+)E", None), (r"Lb([01])E", None)) * 4:
                t = re.match(tok, rest)
                if t:  # S<n>_ repeats an earlier type: here always the first
                    args.append(args[0] if label == "S_" else label or t.group(1))
                    rest = rest[t.end():]
            return f"{name}<{', '.join(args)}>"
    return mangled


def dtype_name(t: torch.Tensor) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(t.dtype, str(t.dtype)[6:])


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def assert_close(name: str, got, want, rtol: float, atol: float) -> float:
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
    log(f"  {name}: ok, max abs err {err:.3e} (rtol {rtol}, atol {atol})")
    return err


def limit_share(got, want, rtol: float, row_tol: float) -> float:
    """Largest |got - want| / (rtol |want| + row_tol rms(want's row)) over
    the elements, a row being the last dim: at most 1 is a pass."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((g - w).abs() / (rtol * w.abs() + row_tol * rms).clamp_min(1e-30)).max())


def assert_close_rows(name: str, got, want, rtol: float, row_tol: float) -> float:
    err, share = max_err(got, want), limit_share(got, want, rtol, row_tol)
    if not share <= 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs "
                             f"err {err:.3e}, {share:.3f} of the limit: rtol {rtol}, "
                             f"{row_tol} of the row's RMS)")
    log(f"  {name}: ok, max abs err {err:.3e}, {share:.3f} of the limit (rtol {rtol}, "
        f"{row_tol} of the row's RMS)")
    return err


def assert_refused(name: str, planted, want, rtol: float, row_tol: float) -> None:
    """The check of ``assert_close_rows`` must fail on a planted fault."""
    err, share = max_err(planted, want), limit_share(planted, want, rtol, row_tol)
    if share <= 1.0:
        raise AssertionError(f"{name}: the check accepts a planted fault (max abs err "
                             f"{err:.3e}, {share:.3f} of the limit)")
    log(f"  {name}: refused, max abs err {err:.3e}, {share:.3f} of the limit")


def assert_refused_close(name: str, planted, want, rtol: float, atol: float) -> None:
    """The check of ``assert_close`` must fail on a planted fault."""
    if torch.allclose(planted.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: the check accepts a planted fault (max abs err "
                             f"{max_err(planted, want):.3e})")
    log(f"  {name}: refused, max abs err {max_err(planted, want):.3e} (rtol {rtol}, "
        f"atol {atol})")


def assert_equal(name: str, got, want) -> float:
    """Bit-equal (NaN-free inputs: torch.equal counts -inf == -inf)."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel output is not bit-equal to its plain "
                             f"version ({tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype})")
    log(f"  {name}: ok, bit-equal")
    return 0.0


def assert_bits(name: str, got, want) -> float:
    """Bit-equal floats, NaN and the sign of zero included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.equal(got.view(ints[got.dtype]), want.view(ints[want.dtype]))):
        raise AssertionError(f"{name}: kernel output is not bit-equal to its plain "
                             f"version ({tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype})")
    log(f"  {name}: ok, bit-equal (NaN and signed zeros included)")
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU present", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs.dlrm_flexemr import make_config
    from repro_torch.configs.lm_common import LM_SHAPES, serving_config
    from repro_torch.configs.stablelm_3b import make_config as make_lm_config
    from repro_torch import chaos as CH
    from repro_torch.core.adaptive_cache import AdaptiveCacheController, MemoryModel
    from repro_torch.core.embedding import make_hash_cache_from_table
    from repro_torch.core.sharding import make_fused_tables
    from repro_torch.data import synthetic as syn
    from repro_torch.data.pipeline import BucketBatcher
    from repro_torch.hotcache import kernels as HK
    from repro_torch.hotcache import ref as HREF
    from repro_torch.hotcache import table as T
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import dot_interaction as K2
    from repro_torch.kernels import embedding_bag as K1
    from repro_torch.kernels import flash_attention as K6
    from repro_torch.kernels import flash_decode as K7
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as TF
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.prefetch import CooccurrenceMiner, PrefetchEngine, PrefetchPolicy
    from repro_torch.prefetch import kernels as PK
    from repro_torch.prefetch import ref as PREF
    from repro_torch.runtime.elastic import reshard_tables
    from repro_torch.runtime.serving import ATTR_STAGES, FlexEMRServer
    from repro_torch.utils import tree_size_bytes, tree_to

    def launch_counts() -> dict:
        return {"embedding_bag": K1.launches, "embedding_bag_masked": K1.launches_masked,
                "dot_interaction": K2.launches,
                "probe_gather_pool": HK.launches[HK.PROBE],
                "scatter_update": HK.launches[HK.SCATTER],
                "topk_neighbor_select": PK.launches,
                "flash_attention": K6.launches, "flash_attention_f32": K6.launches_f32,
                "flash_decode": K7.launches}

    def reset_counts() -> None:
        K1.launches = K1.launches_masked = 0
        K2.launches = PK.launches = K6.launches = K6.launches_f32 = K7.launches = 0
        HK.launches.update(dict.fromkeys(HK.launches, 0))

    def require(path: str, counts: dict, names) -> None:
        missing = [n for n in names if counts[n] < 1]
        if missing:
            raise AssertionError(f"{path} did not launch {missing}: {counts}")
        if "embedding_bag" in names and counts["embedding_bag_masked"] != counts["embedding_bag"]:
            raise AssertionError(f"{path} launched K1 outside its masked mode: {counts}")

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
    report = build.build([K1.NAME, K2.NAME, HK.PROBE, HK.SCATTER, PK.NAME, K6.NAME,
                          K7.NAME], ptxas_verbose=True)
    log(f"[build] {time.perf_counter() - t0:.2f}s wall for "
        + ", ".join(f"{n} {r['seconds']:.2f}s" for n, r in report.items()))
    for name, r in report.items():  # nvcc -Xptxas -v: registers, spills, warnings
        for line in r["log"].splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                log(f"  {name}: {kernel_name(entry.group(1))}")
            elif "registers" in line or "spill" in line or "C75" in line:
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
    # K1's inputs exactly as DisaggEmbedding.lookup hands them to the kernel
    # (masked mode; a masked slot's id is the padding 0 of its field).
    fused = emb._fused_rows(emb.sharded, batch["indices"])
    ids = fused.reshape(-1).contiguous()
    wts = batch["mask"].reshape(-1).to(torch.float32).contiguous()
    n_bags = FORWARD_BATCH * cfg.num_fields
    nnz = ids.numel() // n_bags
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    # --------------------------------------------------------------- kernels
    log("[kernels] each kernel against its plain version on the card")
    k1_out = K1.embedding_bag(table, ids, wts, n_bags, masked=True)
    k1_err = assert_close(f"K1 embedding_bag masked f32 [{n_bags} bags x {nnz}, "
                          f"D={table.shape[1]}]", k1_out,
                          ref.embedding_bag_ref(table, ids, wts, n_bags, masked=True), 1e-5, 1e-5)
    k1w_err = assert_close("K1 embedding_bag weighted f32 (same bags)",
                           K1.embedding_bag(table, ids, wts, n_bags),
                           ref.embedding_bag_ref(table, ids, wts, n_bags), 1e-5, 1e-5)
    small = torch.empty((1 << 20, 64), dtype=torch.bfloat16, device=dev).normal_(
        0, 0.01, generator=torch.Generator(device=dev).manual_seed(1))
    ids_small = (ids % small.shape[0]).to(torch.int32)
    for masked in (True, False):
        assert_close(f"K1 embedding_bag {'masked' if masked else 'weighted'} bf16 "
                     "[1M-row table, same bags]",
                     K1.embedding_bag(small, ids_small, wts, n_bags, masked=masked),
                     ref.embedding_bag_ref(small, ids_small, wts, n_bags, masked=masked),
                     1e-5, 1e-5)
    # NaN in every row that only zero-weight slots point to: the masked mode
    # reads none of them, the weighted mode gives NaN where its plain version does.
    dead = ~torch.isin(ids_small, ids_small[wts != 0]) & (wts == 0)
    for dt in (torch.float32, torch.bfloat16):
        nan_tab = small.to(dt)
        nan_tab[ids_small[dead].long()] = float("nan")
        got = K1.embedding_bag(nan_tab, ids_small, wts, n_bags, masked=True)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 masked {dtype_name(nan_tab)}: NaN behind w = 0 reached "
                                 "the output")
        assert_close(f"K1 embedding_bag masked {dtype_name(nan_tab)}, NaN in the "
                     f"{int(dead.sum())} zero-weight slots' rows: finite, vs plain", got,
                     ref.embedding_bag_ref(nan_tab, ids_small, wts, n_bags, masked=True),
                     1e-5, 1e-5)
        got = K1.embedding_bag(nan_tab, ids_small, wts, n_bags)
        want = ref.embedding_bag_ref(nan_tab, ids_small, wts, n_bags)
        if not torch.equal(got.isnan(), want.isnan()) or not bool(want.isnan().any()):
            raise AssertionError(f"K1 weighted {dtype_name(nan_tab)}: NaN at other places "
                                 f"than the plain version's ({int(got.isnan().sum())} vs "
                                 f"{int(want.isnan().sum())})")
        fin = ~want.isnan()
        assert_close(f"K1 embedding_bag weighted {dtype_name(nan_tab)}, same table: NaN in "
                     f"the same {int((~fin).sum())} outputs, the rest", got[fin], want[fin],
                     1e-5, 1e-5)
    del small, nan_tab, got, want, fin, dead
    # Edge cases: nnz with and without an unrolled loop, 1003 bags (no
    # multiple of a block's 8, 16 or 32), ids outside [0, V), fractional
    # weights, rows of 17 (element loads) and 256 (two passes of 32 lanes).
    egen = torch.Generator(device=dev).manual_seed(4)
    for nnz_e, width, dt in ((1, 64, torch.float32), (3, 64, torch.float32),
                             (4, 64, torch.float32), (8, 64, torch.float32),
                             (1, 64, torch.bfloat16), (3, 64, torch.bfloat16),
                             (4, 64, torch.bfloat16), (8, 64, torch.bfloat16),
                             (4, 17, torch.float32), (3, 17, torch.bfloat16),
                             (4, 256, torch.float32), (8, 256, torch.bfloat16)):
        V_e, bags_e = 5000, 1003
        tab = torch.randn((V_e, width), device=dev, generator=egen).to(dt)
        ids_e = torch.randint(-50, V_e + 50, (bags_e * nnz_e,), device=dev, generator=egen,
                              dtype=torch.int32)
        w_e = torch.rand(bags_e * nnz_e, device=dev, generator=egen) + 0.5
        w_e[torch.rand(bags_e * nnz_e, device=dev, generator=egen) < 0.5] = 0.0
        for masked in (True, False):
            assert_close(f"K1 embedding_bag {'masked' if masked else 'weighted'} "
                         f"{dtype_name(tab)} nnz {nnz_e} D {width} [{bags_e} bags, ids in "
                         f"[-50, {V_e + 50})]",
                         K1.embedding_bag(tab, ids_e, w_e, bags_e, masked=masked),
                         ref.embedding_bag_ref(tab, ids_e, w_e, bags_e, masked=masked),
                         1e-5, 1e-5)
    del tab, ids_e, w_e
    gen = torch.Generator(device=dev).manual_seed(2)
    x_fwd = torch.randn((FORWARD_BATCH, cfg.num_fields + 1, cfg.embed_dim),
                        device=dev, generator=gen)
    k2_err = assert_close(f"K2 dot_interaction f32 {list(x_fwd.shape)}",
                          K2.dot_interaction(x_fwd), ref.dot_interaction_ref(x_fwd), 1e-4, 1e-4)
    x_bf = x_fwd.to(torch.bfloat16)
    assert_close(f"K2 dot_interaction bf16 {list(x_bf.shape)}",
                 K2.dot_interaction(x_bf), ref.dot_interaction_ref(x_bf), 1e-4, 1e-4)
    k2_buckets = {}  # the serve buckets' [B, 17, 64] inputs, checked here, timed below
    for bucket in SERVE_BUCKETS:
        x_srv = torch.randn((bucket, SERVE_FIELDS, cfg.embed_dim), device=dev, generator=gen)
        for x_ in (x_srv, x_srv.to(torch.bfloat16)):
            assert_close(f"K2 dot_interaction {dtype_name(x_)} {list(x_.shape)} (serve bucket)",
                         K2.dot_interaction(x_), ref.dot_interaction_ref(x_), 1e-4, 1e-4)
        k2_buckets[bucket] = x_srv
    x_big = torch.randn((3, 40, 512), device=dev, generator=gen)
    for x_ in (x_big, x_big.to(torch.bfloat16)):
        assert_close(f"K2 dot_interaction {dtype_name(x_)} {list(x_.shape)} (one sample "
                     "> 48 KB shared)", K2.dot_interaction(x_), ref.dot_interaction_ref(x_),
                     1e-4, 1e-4)

    D = table.shape[1]
    live = ids[wts != 0]

    def k1_bytes(rows):
        return (torch.unique(rows).numel() * D * 4  # rows the bags need, once
                + ids.numel() * 8  # ids + weights
                + n_bags * D * 4)  # pooled output

    k1_bound, k1_by = bound(k1_bytes(live), 2 * live.numel() * D)  # masked: live slots
    k1w_bound = bound(k1_bytes(ids), 2 * ids.numel() * D)  # weighted: every slot
    B, Fx, Dx = x_fwd.shape
    k2_bound, k2_by = bound(B * Fx * Dx * 4 + B * Fx * Fx * 4, 2 * B * Fx * Fx * Dx)
    ids_2d = ids.view(n_bags, nnz)
    k1_lib_ms = cuda_ms(lambda: F.embedding_bag(ids_2d, table, mode="sum",
                                                per_sample_weights=wts.view(n_bags, nnz)),
                        flush)
    timings = {
        "embedding_bag": (
            cuda_ms(lambda: K1.embedding_bag(table, ids, wts, n_bags, masked=True), flush),
            cuda_ms(lambda: ref.embedding_bag_ref(table, ids, wts, n_bags, masked=True), flush),
            k1_lib_ms,
        ),
        "dot_interaction": (
            cuda_ms(lambda: K2.dot_interaction(x_fwd), flush),
            cuda_ms(lambda: ref.dot_interaction_ref(x_fwd), flush),
            cuda_ms(lambda: torch.bmm(x_fwd, x_fwd.transpose(1, 2)), flush),
        ),
    }
    bounds = {"embedding_bag": (k1_bound, k1_by), "dot_interaction": (k2_bound, k2_by)}
    errs = {"embedding_bag": k1_err, "dot_interaction": k2_err}
    # K1's weighted mode (the Pallas kernel's contract), beside the masked one
    # that the main path runs: its own bound reads every slot's row.
    k1_weighted = {
        "ms": cuda_ms(lambda: K1.embedding_bag(table, ids, wts, n_bags), flush),
        "plain_ms": cuda_ms(lambda: ref.embedding_bag_ref(table, ids, wts, n_bags), flush),
        "library_ms": k1_lib_ms, "bound_ms": k1w_bound[0], "bound_by": k1w_bound[1],
        "max_abs_err": k1w_err,
    }
    # The same launches with the L2 flushed by a read (no dirty lines left
    # for the kernel to write back), beside the write-flushed medians.
    k1_weighted["ms_read_flush"] = cuda_ms(
        lambda: K1.embedding_bag(table, ids, wts, n_bags), flush, read_flush=True)
    read_flushed = {"embedding_bag": cuda_ms(
        lambda: K1.embedding_bag(table, ids, wts, n_bags, masked=True), flush, read_flush=True)}
    log(f"  bounds: K1 masked moves {k1_bytes(live) / 1e6:.2f} MB ({torch.unique(live).numel()} "
        f"unique live rows of {live.numel()} live slots), weighted {k1_bytes(ids) / 1e6:.2f} MB "
        f"({torch.unique(ids).numel()} unique rows of {ids.numel()} slots); K2 moves "
        f"{(B * Fx * Dx + B * Fx * Fx) * 4 / 1e6:.2f} MB")
    log(f"  K1 weighted: kernel {k1_weighted['ms']:.4f} ms, plain {k1_weighted['plain_ms']:.4f} "
        f"ms, F.embedding_bag {k1_lib_ms:.4f} ms, bound {k1w_bound[0]:.6f} ms (the kernel "
        f"reaches {k1w_bound[0] / k1_weighted['ms']:.1%} of it); L2 flushed by a read "
        f"{k1_weighted['ms_read_flush']:.4f} ms")
    k2_rows = []  # K2 at the serve buckets, beside torch.bmm, in turns
    for bucket, x_ in k2_buckets.items():
        Bb, Fb, Db = x_.shape
        kern = lambda: K2.dot_interaction(x_)  # noqa: E731
        lib = lambda: torch.bmm(x_, x_.transpose(1, 2))  # noqa: E731
        t_kern, t_lib = [], []
        for fn, times in ((kern, t_kern), (lib, t_lib), (lib, t_lib), (kern, t_kern)):
            times.append(cuda_ms(fn, flush))
        k2_rows.append({"case": f"K2 f32 [{Bb}, {Fb}, {Db}] (serve bucket)",
                        "ms": statistics.median(t_kern), "library_ms": statistics.median(t_lib),
                        "bound_ms": bound(Bb * Fb * Db * 4 + Bb * Fb * Fb * 4,
                                          2 * Bb * Fb * Fb * Db)[0]})
    log("[kernels] K2 at the serve buckets: " + json.dumps(k2_rows))
    del x_fwd, x_bf, x_srv, x_big, k1_out, k2_buckets

    # ---- hot set of the cached forward: fused ids of warm-up batches by count
    warm = np.random.default_rng(1)
    warm_ids = []
    for _ in range(WARMUP_BATCHES):
        wb = syn.recsys_batch(warm, cfg.tables, FORWARD_BATCH, n_dense=cfg.n_dense)
        wf = emb._fused_rows(emb.sharded, torch.from_numpy(wb["indices"])).numpy()
        warm_ids.append(wf[wb["mask"]])
    uniq, counts = np.unique(np.concatenate(warm_ids), return_counts=True)
    hot_ids = uniq[np.argsort(-counts, kind="stable")].astype(np.int32)
    log(f"  hot set: {len(hot_ids)} unique fused ids in {WARMUP_BATCHES} warm-up "
        f"batches of {FORWARD_BATCH}; cache of {HOT_SLOTS} slots, P = {MAX_PROBES}")

    # ---- K4 at the cache build's writes (the swap-in of make_hash_cache_from_table)
    C = HOT_SLOTS
    h = hot_ids[:C]
    keys_np, freq_np, _, w_slots, w_idx = T.insert_plan(
        np.full((C,), T.EMPTY_KEY, np.int32), np.zeros((C,), np.int32), h,
        np.arange(len(h), 0, -1, dtype=np.int32), 1, MAX_PROBES)
    hot_rows = emb.gather_rows(params["emb"], torch.from_numpy(h).to(dev))
    slots_t = torch.from_numpy(w_slots).to(dev)
    rows_w = hot_rows[torch.from_numpy(w_idx).to(dev)]
    values = torch.zeros((C, D), dtype=torch.float32, device=dev)
    k4_err = assert_equal(
        f"K4 scatter_update f32 [{len(w_slots)} writes into {C} x {D}] (cache build)",
        HK.scatter_update(values, slots_t, rows_w),
        HREF.scatter_update_ref(torch.zeros_like(values), slots_t, rows_w))
    assert_equal("K4 scatter_update f32 rows -> bf16 values (cache build)",
                 HK.scatter_update(torch.zeros((C, D), dtype=torch.bfloat16, device=dev),
                                   slots_t, rows_w),
                 HREF.scatter_update_ref(torch.zeros((C, D), dtype=torch.bfloat16,
                                                     device=dev), slots_t, rows_w))
    rep_slots = torch.randint(0, 4096, (65536,), device=dev, generator=gen,
                              dtype=torch.int32)  # every slot written ~16 times
    rep_rows = torch.randn((65536, D), device=dev, generator=gen)
    for vdt in (torch.float32, torch.bfloat16):
        base = torch.randn((8192, D), device=dev, generator=gen).to(vdt)
        assert_equal(f"K4 scatter_update f32 rows -> {str(vdt)[6:]} values, 65536 "
                     "writes to 4096 repeated slots (last write wins)",
                     HK.scatter_update(base.clone(), rep_slots, rep_rows),
                     HREF.scatter_update_ref(base.clone(), rep_slots, rep_rows))
    del rep_rows
    # Slots outside [0, C) mixed in, one write, bf16 rows, and a width of 17
    # (rows of 68 or 34 bytes: the element-wise copy).
    mixed = torch.randint(-64, 8192 + 64, (4096,), device=dev, generator=gen,
                          dtype=torch.int32)
    one = torch.tensor([5000], dtype=torch.int32, device=dev)
    f32_, bf16_ = torch.float32, torch.bfloat16
    for sl, vdt, rdt, width in ((mixed, f32_, f32_, D), (mixed, bf16_, bf16_, D),
                                (mixed, f32_, bf16_, D), (mixed, bf16_, f32_, D),
                                (mixed, f32_, f32_, 17), (mixed, bf16_, f32_, 17),
                                (mixed, f32_, bf16_, 17), (mixed, bf16_, bf16_, 17),
                                (one, f32_, f32_, D), (one, bf16_, f32_, 17)):
        base = torch.randn((8192, width), device=dev, generator=gen).to(vdt)
        rows_x = torch.randn((sl.shape[0], width), device=dev, generator=gen).to(rdt)
        what = "one write (K = 1)" if sl is one else "4096 writes, slots outside [0, C) mixed in"
        assert_equal(f"K4 scatter_update {dtype_name(rows_x)} rows -> {dtype_name(base)} "
                     f"values, D = {width}, 8192 slots, {what}",
                     HK.scatter_update(base.clone(), sl, rows_x),
                     HREF.scatter_update_ref(base.clone(), sl, rows_x))
    del mixed, one, base, rows_x
    check_cache = T.HashCacheState(keys=torch.from_numpy(keys_np).to(dev), rows=values,
                                   freq=torch.from_numpy(freq_np).to(dev))
    occupied = int(check_cache.occupancy())

    # ---- K3 on the forward batch's sharded-field query over that cache
    msk = batch["mask"].reshape(-1)
    query = torch.where(msk, fused.reshape(-1), T.EMPTY_KEY).contiguous()
    k3_out = HK.probe_gather_pool(check_cache.keys, check_cache.rows, query, wts,
                                  n_bags, MAX_PROBES)
    k3_want = HREF.probe_gather_pool_ref(check_cache.keys, check_cache.rows, query,
                                         wts, n_bags, MAX_PROBES)
    assert_equal(f"K3 probe_gather_pool miss [{n_bags} bags x {nnz}, C = {C}]",
                 k3_out[1], k3_want[1])
    k3_err = assert_close(f"K3 probe_gather_pool pooled f32 [{n_bags}, {D}]",
                          k3_out[0], k3_want[0], 1e-5, 1e-5)
    rows_bf = check_cache.rows.to(torch.bfloat16)
    got_bf = HK.probe_gather_pool(check_cache.keys, rows_bf, query, wts, n_bags, MAX_PROBES)
    want_bf = HREF.probe_gather_pool_ref(check_cache.keys, rows_bf, query, wts, n_bags,
                                         MAX_PROBES)
    assert_equal("K3 probe_gather_pool miss (bf16 rows)", got_bf[1], want_bf[1])
    assert_close("K3 probe_gather_pool pooled (bf16 rows)", got_bf[0], want_bf[0],
                 1e-5, 1e-5)
    del rows_bf, got_bf, want_bf
    # Edge cases: nnz 1, 3, 4, 8; 1003 bags; caches of 1 and 4 slots (the
    # window repeats slots) and of 1024 (some windows wrap past C - 1); ids
    # resident, cold, negative, past every fused row (2^30 and up) and
    # EMPTY_KEY; fractional weights; rows of 17 (element loads).
    kgen = np.random.default_rng(5)
    for C_e, nnz_e, width, dt in ((1024, 1, 64, torch.float32), (1024, 3, 64, torch.float32),
                                  (1024, 4, 64, torch.float32), (1024, 8, 64, torch.float32),
                                  (1024, 4, 64, torch.bfloat16), (1024, 8, 64, torch.bfloat16),
                                  (4, 3, 64, torch.float32), (1, 4, 64, torch.bfloat16),
                                  (1024, 4, 17, torch.float32), (1024, 3, 17, torch.bfloat16)):
        bags_e, n_e = 1003, 1003 * nnz_e
        res = kgen.choice(1 << 20, max(1, int(C_e * 0.6)), replace=False).astype(np.int32)
        keys_e = T.insert_plan(np.full((C_e,), T.EMPTY_KEY, np.int32),
                               np.zeros((C_e,), np.int32), res,
                               np.ones(len(res), np.int32), 1, MAX_PROBES)[0]
        held = keys_e[keys_e != T.EMPTY_KEY]
        pick = kgen.integers(0, 5, n_e)
        q_np = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                         [kgen.choice(held, n_e), kgen.integers(1 << 20, 1 << 30, n_e),
                          -kgen.integers(1, 1 << 30, n_e),
                          kgen.integers(1 << 30, (1 << 31) - 1, n_e)],
                         T.EMPTY_KEY).astype(np.int32)
        q_e = torch.from_numpy(q_np).to(dev)
        w_e = torch.from_numpy(kgen.random(n_e).astype(np.float32) + 0.5).to(dev)
        keys_t = torch.from_numpy(keys_e).to(dev)
        vals_e = torch.randn((C_e, width), device=dev, generator=gen).to(dt)
        got = HK.probe_gather_pool(keys_t, vals_e, q_e, w_e, bags_e, MAX_PROBES)
        want = HREF.probe_gather_pool_ref(keys_t, vals_e, q_e, w_e, bags_e, MAX_PROBES)
        what = (f"{dtype_name(vals_e)} C {C_e} nnz {nnz_e} D {width} [{bags_e} bags, "
                f"{int((~want[1]).sum())} hits of {n_e}]")
        assert_equal(f"K3 probe_gather_pool miss {what}", got[1], want[1])
        assert_close(f"K3 probe_gather_pool pooled {what}", got[0], want[0], 1e-5, 1e-5)
    del keys_t, vals_e, q_e, w_e, got, want
    hit = ~k3_out[1]
    n_live = int((query != T.EMPTY_KEY).sum())
    n_hits = int(hit.sum())
    uniq_hit_rows = torch.unique(query[hit]).numel()
    k3_bytes = (ids.numel() * 8  # ids + weights
                + n_live * 4  # one key per live id
                + uniq_hit_rows * D * 4  # the hit rows, once
                + n_bags * D * 4 + ids.numel())  # pooled output + miss bytes
    bounds["probe_gather_pool"] = bound(k3_bytes, 2 * n_hits * D)
    errs["probe_gather_pool"] = k3_err
    log(f"  K3 query: {n_live} live ids, {n_hits} hits ({uniq_hit_rows} unique rows) "
        f"in a cache holding {occupied} of {len(h)} hot ids; moves {k3_bytes / 1e6:.2f} MB")

    # ---- K5: the miner's [M, 16] f64 lists and the TPU-shaped [4096, 128] f32
    def tied_scores(m, width, dtype):
        """Scores on a grid of 1/4 (ties), with -inf, NaN, -0.0 and +0.0
        scattered in, an all-NaN row and an all -inf last row (it walks its
        columns in order)."""
        s = torch.round(torch.randn((m, width), device=dev, generator=gen) * 4) / 4
        u = torch.rand((m, width), device=dev, generator=gen)
        s[u < 0.2] = float("-inf")
        s[(u >= 0.2) & (u < 0.3)] = float("nan")
        s[(u >= 0.3) & (u < 0.4)] = -0.0
        s[(u >= 0.4) & (u < 0.5)] = 0.0
        s[-2] = float("nan")
        s[-1] = float("-inf")
        return s.to(dtype).contiguous()

    k5_cases = {}
    for m, width, k in ((MINER_ROWS, 16, 12), (2048, 16, 12), (4096, 128, 32)):
        for dt in (torch.float32, torch.float64):
            s = tied_scores(m, width, dt)
            gv, gi = PK.topk_neighbor_select(s, k)
            wv, wi = PREF.topk_neighbor_select_ref(s, k)
            name = f"K5 topk_neighbor_select {str(dt)[6:]} [{m}, {width}] k={k}"
            assert_bits(f"{name} values", gv, wv)
            assert_equal(f"{name} indices", gi, wi)
            k5_cases[(m, width, dt)] = (s, k)
    # Edges of the kernel's row plan: one column, a group of 16 lanes and one
    # column past it, a whole warp and one column past it (a warp a row), and
    # 1003 rows (no multiple of a block's rows); k = 1 and k = L.
    for width in K5_EDGE_WIDTHS:
        for k in sorted({1, width}):
            for dt in (torch.float32, torch.float64):
                s = tied_scores(1003, width, dt)
                gv, gi = PK.topk_neighbor_select(s, k)
                wv, wi = PREF.topk_neighbor_select_ref(s, k)
                name = f"K5 topk_neighbor_select {str(dt)[6:]} [1003, {width}] k={k}"
                assert_bits(f"{name} values", gv, wv)
                assert_equal(f"{name} indices", gi, wi)
    errs["topk_neighbor_select"] = 0.0
    errs["scatter_update"] = k4_err

    # ---- timings of K3, K4, K5 (plain versions and library calls beside)
    last = torch.full((C,), -1, dtype=torch.int64, device=dev)
    order = torch.arange(len(w_slots), device=dev)
    last.scatter_reduce_(0, slots_t.long(), order, reduce="amax")
    keep = last[slots_t.long()] == order
    slots_u, rows_u = slots_t[keep].long(), rows_w[keep]
    scratch = torch.zeros((C, D), dtype=torch.float32, device=dev)
    bounds["scatter_update"] = bound(int(keep.sum()) * D * 8 + len(w_slots) * 4, 0)
    s_miner, k_miner = k5_cases[(MINER_ROWS, 16, torch.float64)]
    bounds["topk_neighbor_select"] = bound(
        s_miner.numel() * 8 + s_miner.shape[0] * k_miner * 12, 0)
    timings["probe_gather_pool"] = (
        cuda_ms(lambda: HK.probe_gather_pool(check_cache.keys, check_cache.rows, query,
                                             wts, n_bags, MAX_PROBES), flush),
        cuda_ms(lambda: HREF.probe_gather_pool_ref(check_cache.keys, check_cache.rows,
                                                   query, wts, n_bags, MAX_PROBES), flush),
        None,  # no single PyTorch call probes a hash table
    )
    read_flushed["probe_gather_pool"] = cuda_ms(
        lambda: HK.probe_gather_pool(check_cache.keys, check_cache.rows, query, wts, n_bags,
                                     MAX_PROBES), flush, read_flush=True)
    timings["scatter_update"] = (
        cuda_ms(lambda: HK.scatter_update(scratch, slots_t, rows_w), flush),
        cuda_ms(lambda: HREF.scatter_update_ref(scratch, slots_t, rows_w), flush),
        cuda_ms(lambda: scratch.index_copy_(0, slots_u, rows_u), flush),
    )
    timings["topk_neighbor_select"] = (
        cuda_ms(lambda: PK.topk_neighbor_select(s_miner, k_miner), flush),
        cuda_ms(lambda: PREF.topk_neighbor_select_ref(s_miner, k_miner), flush),
        cuda_ms(lambda: torch.topk(s_miner, k_miner, dim=1), flush),
    )
    s_tpu, k_tpu = k5_cases[(4096, 128, torch.float32)]
    k5_tpu = (cuda_ms(lambda: PK.topk_neighbor_select(s_tpu, k_tpu), flush),
              cuda_ms(lambda: PREF.topk_neighbor_select_ref(s_tpu, k_tpu), flush),
              cuda_ms(lambda: torch.topk(s_tpu, k_tpu, dim=1), flush),
              bound(s_tpu.numel() * 4 + s_tpu.shape[0] * k_tpu * 8, 0)[0])
    for name, (ms, plain_ms, lib_ms) in timings.items():
        bms, by = bounds[name]
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        rf = (f"; L2 flushed by a read {read_flushed[name]:.4f} ms"
              if name in read_flushed else "")
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib}, bound {bms:.6f} ms (by {by}; the "
            f"kernel reaches {bms / ms:.1%} of it){rf}")
    log(f"  K4 timed at the cache build: {len(w_slots)} writes, {int(keep.sum())} "
        f"survive; K5 timed at the miner's [{MINER_ROWS}, 16] f64, k={k_miner}")
    log(f"  K5 at [4096, 128] f32 k={k_tpu}: kernel {k5_tpu[0]:.4f} ms, plain "
        f"{k5_tpu[1]:.4f} ms, torch.topk {k5_tpu[2]:.4f} ms, bound {k5_tpu[3]:.6f} ms")
    del scratch, last, order, keep, slots_u, rows_u, k5_cases, s_tpu, k3_out, k3_want
    del check_cache, values, hot_rows, rows_w, slots_t

    # --------------------------------------------------------------- forward
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        scores = R.forward(cfg, params, batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = launch_counts()
    require("forward", fwd_launches, ("embedding_bag", "dot_interaction"))
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

    # -------------------------------------------------------- cached forward
    host2 = syn.recsys_batch(np.random.default_rng(2), cfg.tables, FORWARD_BATCH,
                             n_dense=cfg.n_dense)
    batch2 = {k: torch.from_numpy(host2[k]).to(dev) for k in ("indices", "mask", "dense")}
    with torch.no_grad():
        scores2 = R.forward(cfg, params, batch2)  # uncached, outside the window
    fused_b = emb._fused_rows(emb.sharded, batch["indices"])[batch["mask"]].cpu().numpy()
    ref_ids, ref_counts = np.unique(fused_b, return_counts=True)

    def hit_rate(cache, b) -> float:
        f = emb._fused_rows(emb.sharded, b["indices"])
        q = torch.where(b["mask"], f, T.EMPTY_KEY)
        return float(T.cache_lookup(cache, q, MAX_PROBES)[1].sum()) / float(b["mask"].sum())

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = make_hash_cache_from_table(emb, params["emb"], hot_ids, HOT_SLOTS,
                                       max_probes=MAX_PROBES, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        scores_c = R.forward(cfg, params, batch, cache=cache)
    hit1 = hit_rate(cache, batch)
    t0 = time.perf_counter()
    ref_rows = emb.gather_rows(params["emb"], torch.from_numpy(ref_ids.astype(np.int32)).to(dev))
    cache, admitted = T.cache_insert(cache, ref_ids, ref_rows, ref_counts, 2, MAX_PROBES)
    cache = T.decay_freq(cache, 0.5)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    with torch.no_grad():
        scores_c2 = R.forward(cfg, params, batch2, cache=cache)
    torch.cuda.synchronize()
    hit2 = hit_rate(cache, batch2)
    cached_launches = launch_counts()
    require("cached_forward", cached_launches,
            ("probe_gather_pool", "scatter_update", "embedding_bag", "dot_interaction"))
    for name, got in (("scores", scores_c), ("scores after refresh", scores_c2)):
        if got.shape != (FORWARD_BATCH,) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"cached forward {name} not finite: {got.shape}")
    assert_close("cached forward scores [2048] vs uncached forward", scores_c, scores,
                 1e-4, 1e-5)
    assert_close("cached forward scores after refresh vs uncached forward", scores_c2,
                 scores2, 1e-4, 1e-5)
    with torch.no_grad():
        pooled_c = emb.lookup(params["emb"], batch["indices"], batch["mask"], cache=cache)
    assert_close("cached lookup pooled [2048, 26, 64] vs lookup_reference", pooled_c,
                 pooled_plain, 1e-5, 1e-5)
    # Cached and uncached forward timed in turns (plain, cached, cached,
    # plain, ...) in this one call, so clocks and allocator state are shared.
    turns = {False: [], True: []}
    with torch.no_grad():
        for i in range(FORWARD_TURNS):
            for cached in ((False, True) if i % 2 == 0 else (True, False)):
                c = cache if cached else None
                turns[cached].append(
                    cuda_ms(lambda: R.forward(cfg, params, batch, cache=c), flush))
    with torch.no_grad():  # device work of each, one profiled window of 3 calls
        profiles = {"uncached": device_busy(lambda: R.forward(cfg, params, batch), 3),
                    "cached": device_busy(lambda: R.forward(cfg, params, batch, cache=cache), 3)}
    log("[cached_forward] " + json.dumps({
        "cache_slots": HOT_SLOTS, "occupancy": int(cache.occupancy()),
        "build_seconds": build_s, "refresh_seconds": refresh_s,
        "refresh_admitted": int(admitted.sum()), "refresh_candidates": len(ref_ids),
        "hit_rate_first": hit1, "hit_rate_after_refresh": hit2,
        "cached_forward_ms": statistics.median(turns[True]),
        "uncached_forward_ms": statistics.median(turns[False]),
        "cached_forward_ms_turns": turns[True], "uncached_forward_ms_turns": turns[False],
        "launches": cached_launches, "profiles": profiles,
    }))
    del params, table, batch, batch2, fused, ids, wts, ids_2d, live, pooled, pooled_plain
    del scores, scores2, scores_c, scores_c2, pooled_c, cache, ref_rows, query
    del flush
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- serve
    args = launch_serve.parse_args(["--requests", str(SERVE_REQUESTS)])
    reset_counts()
    out = launch_serve.run(args)
    srv_launches = launch_counts()
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
        "attr_mean_ms": {k: 1e3 * out["attr"][k]["mean"] for k in ATTR_STAGES},
        "launches": srv_launches,
    }))

    # -------------------------------------------------------- serve_prefetch
    scfg = launch_serve.make_serving_dlrm(1.0)
    sparams = R.init_params(scfg, 0, device=dev)
    # launch.serve.run's controller, with a row cap below the traffic's
    # working set: with its default 65,536 rows every co-occurring partner
    # of a newly planned row is already resident, and nothing is prefetched.
    controller = AdaptiveCacheController(
        scfg.tables, scfg.embed_dim,
        MemoryModel(fixed_bytes=2 << 28, bytes_per_sample=1 << 14, hbm_bytes=1 << 30),
        max_rows=PREFETCH_CACHE_ROWS, field_replication=False)
    engine = PrefetchEngine(
        CooccurrenceMiner(list_len=16, max_rows=16_384, decay=0.99, device=dev),
        PrefetchPolicy(k_neighbors=12, byte_budget=1 << 18, min_score=1.0))
    server = FlexEMRServer(scfg, sparams, make_fused_tables(scfg.tables, scfg.embed_dim, 8),
                           controller=controller, prefetcher=engine,
                           cache_refresh_every=PREFETCH_REFRESH_EVERY,
                           registry=MetricsRegistry(), device=dev)
    wl = syn.CooccurrenceWorkload(scfg.tables, batch=1, alpha=1.1, cooccur_frac=0.8,
                                  pool_size=32, n_dense=scfg.n_dense, seed=0)
    reqs = []
    for _ in range(SERVE_REQUESTS):
        b = wl.next_batch()
        reqs.append({"indices": b["indices"][0], "mask": b["mask"][0],
                     "dense": b["dense"][0]})
    nonfinite = 0
    reset_counts()
    try:
        t0 = time.perf_counter()
        for i in range(0, SERVE_REQUESTS, PREFETCH_BURST):
            for r in reqs[i:i + PREFETCH_BURST]:
                server.submit(r)
            while (res := server.step()) is not None:
                nonfinite += int((~np.isfinite(res["scores"])).sum())
        while server.metrics.requests < SERVE_REQUESTS:
            if (res := server.step()) is not None:
                nonfinite += int((~np.isfinite(res["scores"])).sum())
        torch.cuda.synchronize()
        pf_wall = time.perf_counter() - t0
        pf_launches = launch_counts()
        pf = server.metrics.summary()
    finally:
        server.close()
    if pf["requests"] != SERVE_REQUESTS:
        raise AssertionError(f"serve_prefetch retired {pf['requests']} of {SERVE_REQUESTS}")
    if nonfinite:
        raise AssertionError(f"{nonfinite} non-finite serve_prefetch scores")
    if pf["prefetch_issued"] <= 0:
        raise AssertionError(f"serve_prefetch prefetched nothing: {pf}")
    require("serve_prefetch", pf_launches, ("topk_neighbor_select", "dot_interaction"))
    if pf_launches["dot_interaction"] < pf["batches"]:
        raise AssertionError(f"K2 launched {pf_launches['dot_interaction']} times "
                             f"for {pf['batches']} batches")
    log("[serve_prefetch] " + json.dumps({
        "device": str(server.device), "requests": pf["requests"], "batches": pf["batches"],
        "throughput_rps": SERVE_REQUESTS / pf_wall, "p50_latency_ms": pf["p50_latency_ms"],
        "p99_latency_ms": pf["p99_latency_ms"], "hit_rate": pf["hit_rate"],
        "dense_seconds": pf["dense_seconds"], "lookup_seconds": pf["lookup_seconds"],
        **{k: pf[k] for k in ("prefetch_issued", "prefetch_hits", "prefetch_evicted",
                              "bytes_prefetch", "prefetch_useful_rate")},
        "miner_pairs_observed": engine.miner.pairs_observed,
        "prefetch_triggers": engine.stats.triggers, "launches": pf_launches,
    }))

    # ------------------------------------------------------- serve_open_loop
    qps = int(out["throughput_rps"] / 2)  # half of the closed loop's rate above
    args = launch_serve.parse_args(["--arrival", "poisson", "--qps", str(qps),
                                    "--duration", str(OPEN_LOOP_SECONDS)])
    t0 = time.perf_counter()
    reset_counts()
    ol = launch_serve.run(args)
    ol_launches = launch_counts()
    ol_seconds = time.perf_counter() - t0
    lg = ol["loadgen"]
    if ol["requests"] + lg["shed"] != lg["submitted"] or ol["requests"] == 0:
        raise AssertionError(f"serve_open_loop retired {ol['requests']} and shed "
                             f"{lg['shed']} of {lg['submitted']} arrivals")
    if ol["nonfinite_scores"]:
        raise AssertionError(f"{ol['nonfinite_scores']} non-finite serve_open_loop scores")
    if ol_launches["dot_interaction"] < ol["batches"]:
        raise AssertionError(f"K2 launched {ol_launches['dot_interaction']} times "
                             f"for {ol['batches']} batches")
    log("[serve_open_loop] " + json.dumps({
        "device": ol["device"], "qps_arg": qps, "offered_qps": lg["offered_qps"],
        "achieved_qps": lg["achieved_qps"], "arrivals": lg["submitted"],
        "shed": lg["shed"], "requests": ol["requests"], "batches": ol["batches"],
        "p50_latency_ms": ol["p50_latency_ms"], "p99_latency_ms": ol["p99_latency_ms"],
        "submit_lag_mean_ms": 1e3 * lg["submit_lag_mean_s"],
        "submit_lag_max_ms": 1e3 * lg["submit_lag_max_s"], "driver_wall_s": lg["wall_s"],
        "driver_steps": lg["steps"],
        "queue_wait_p50_ms": 1e3 * ol["queue_wait"]["p50"],
        "queue_wait_p99_ms": 1e3 * ol["queue_wait"]["p99"],
        "attr_mean_ms": {k: 1e3 * ol["attr"][k]["mean"] for k in ATTR_STAGES},
        "slo": {k: ol["slo"][k] for k in ("requests", "good_fraction", "breaches",
                                          "throughput_rps", "goodput_rps", "burn_fast",
                                          "burn_slow", "alerting", "alerts_fired")},
        "slo_target_ms": 1e3 * ol["slo"]["objective"]["latency_target_s"],
        "phase_seconds": ol_seconds, "launches": ol_launches,
    }))

    # ----------------------------------------------------------- serve_chaos
    crng = np.random.default_rng(0)
    cb = syn.recsys_batch(crng, scfg.tables, CHAOS_BATCHES * CHAOS_BUCKET,
                          n_dense=scfg.n_dense)
    chaos_reqs = [{"indices": cb["indices"][i], "mask": cb["mask"][i],
                   "dense": cb["dense"][i]} for i in range(len(cb["dense"]))]
    chaos_tables = make_fused_tables(scfg.tables, scfg.embed_dim, CHAOS_SHARDS)
    scenario = CH.FaultSchedule(faults=(  # one fault of each kind
        CH.FaultSpec(CH.FAULT_KILL_ENGINE, at_batch=2, target=1),
        CH.FaultSpec(CH.FAULT_DROP_SHARD, at_batch=3, target=0, duration_batches=2),
        CH.FaultSpec(CH.FAULT_STRAGGLER_STORM, at_batch=4, target=1,
                     duration_batches=2, latency_mult=8.0),
        CH.FaultSpec(CH.FAULT_RESHARD, at_batch=5, target=CHAOS_RESHARD_TO),
    ), seed=0)

    def drive_chaos(schedule):
        """launch.serve's server (depth 2, 4 engines) over one fixed bucket,
        the queue pre-filled, driven by explicit admits and retires: every
        run forms the same batches, so the dense stage's GEMMs see the same
        shapes and their bits can be compared."""
        injector = (None if schedule is None
                    else CH.ChaosInjector(schedule, watchdog_s=CHAOS_WATCHDOG_S))
        server = FlexEMRServer(
            scfg, sparams, chaos_tables,
            controller=AdaptiveCacheController(
                scfg.tables, scfg.embed_dim,
                MemoryModel(fixed_bytes=2 << 28, bytes_per_sample=1 << 14,
                            hbm_bytes=1 << 30),
                max_rows=65536, field_replication=False),
            num_engines=4, pipeline_depth=2,
            batcher=BucketBatcher(buckets=(CHAOS_BUCKET,), max_wait=CHAOS_WAIT_S),
            chaos=injector, registry=MetricsRegistry(), device=dev)
        outs = []
        try:
            for r in chaos_reqs:
                server.submit(r)
            t0 = time.perf_counter()
            admitted = 0
            while True:
                while len(server._pipeline) < server.pipeline_depth \
                        and admitted < CHAOS_BATCHES:
                    if not server._admit_next():
                        raise AssertionError("serve_chaos: a pre-filled poll came back empty")
                    admitted += 1
                if not server._pipeline:
                    break
                outs.append(server._retire_oldest()["scores"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            vlat = np.asarray(server.service.virtual_latencies)
            eng = server.engine_summary()
        finally:
            server.close()
        return outs, injector, wall, vlat, eng

    t0 = time.perf_counter()
    clean, _, clean_wall, _, _ = drive_chaos(None)
    reset_counts()
    faulty, injector, chaos_wall, chaos_vlat, chaos_eng = drive_chaos(scenario)
    chaos_launches = launch_counts()
    again, injector2, _, _, _ = drive_chaos(scenario)
    chaos_seconds = time.perf_counter() - t0
    cs = injector.summary()
    if not len(clean) == len(faulty) == len(again) == CHAOS_BATCHES:
        raise AssertionError(f"serve_chaos retired {len(clean)}, {len(faulty)} and "
                             f"{len(again)} batches (wanted {CHAOS_BATCHES})")
    for i, (a, b) in enumerate(zip(clean, faulty)):
        if not (a.shape == b.shape and a.dtype == b.dtype == np.float32
                and np.array_equal(a.view(np.int32), b.view(np.int32))):
            raise AssertionError(f"serve_chaos: batch {i}'s scores under faults are not "
                                 f"bit-equal to the fault-free run's "
                                 f"(max abs diff {np.abs(a - b).max():.3e})")
        if not np.isfinite(a).all():
            raise AssertionError(f"serve_chaos: non-finite scores in batch {i}")
    log(f"  serve_chaos: {CHAOS_BATCHES} batches of {CHAOS_BUCKET}, scores under "
        "faults bit-equal to the fault-free run's, batch by batch")
    if cs["by_kind"] != {k: 1 for k in CH.FAULT_KINDS} or cs["faults_skipped"] \
            or [k for (_, k, _) in cs["firing_log"]] != list(CH.FAULT_KINDS):
        raise AssertionError(f"serve_chaos: not every fault fired once: {cs}")
    if cs["restores"] != 1 or cs["active_drops"] or chaos_eng["killed_threads"] != 1:
        raise AssertionError(f"serve_chaos: a fault did not recover: {cs}, {chaos_eng}")
    want_moved = reshard_tables(chaos_tables, sparams["emb"]["table"].cpu().numpy(),
                                CHAOS_RESHARD_TO).moved_rows
    if cs["moved_rows"] != want_moved or cs["reshards"] != 1:
        raise AssertionError(f"serve_chaos: reshard moved {cs['moved_rows']} rows, "
                             f"reshard_tables counts {want_moved}")
    if injector2.summary()["firing_log"] != cs["firing_log"]:
        raise AssertionError(f"serve_chaos: a second run fired "
                             f"{injector2.summary()['firing_log']}, the first "
                             f"{cs['firing_log']}")
    if chaos_launches["dot_interaction"] < CHAOS_BATCHES:
        raise AssertionError(f"K2 launched {chaos_launches['dot_interaction']} times "
                             f"for {CHAOS_BATCHES} batches")
    log("[serve_chaos] " + json.dumps({
        "batches": CHAOS_BATCHES, "bucket": CHAOS_BUCKET,
        "clean_wall_s": clean_wall, "chaos_wall_s": chaos_wall,
        "firing_log": cs["firing_log"], "moved_rows": cs["moved_rows"],
        "moved_rows_host": want_moved, "inflight_invalidated": cs["inflight_invalidated"],
        "rows_re_replicated": cs["rows_re_replicated"], "restores": cs["restores"],
        "wall": cs["wall"], "virtual_p50_us": 1e6 * float(np.median(chaos_vlat)),
        "virtual_p99_us": 1e6 * float(np.quantile(chaos_vlat, 0.99)),
        "same_firing_log_twice": True, "phase_seconds": chaos_seconds,
        "launches": chaos_launches,
    }))

    # --------------------------------------------------------- serve_reshard
    args = launch_serve.parse_args(["--requests", str(SERVE_REQUESTS), "--chaos-seed", "0",
                                    "--reshard-to", str(RESHARD_TO)])
    t0 = time.perf_counter()
    reset_counts()
    rs = launch_serve.run(args)
    rs_launches = launch_counts()
    rs_seconds = time.perf_counter() - t0
    if not rs["requests"] == rs["submitted"] == SERVE_REQUESTS:
        raise AssertionError(f"serve_reshard served {rs['requests']} of {rs['submitted']} "
                             f"(wanted {SERVE_REQUESTS})")
    if rs["nonfinite_scores"]:
        raise AssertionError(f"{rs['nonfinite_scores']} non-finite serve_reshard scores")
    rc = rs["chaos"]
    if ("reshard", RESHARD_TO) not in [(k, t) for (_, k, t) in rc["firing_log"]] \
            or rc["moved_rows"] <= 0 or rc["active_drops"]:
        raise AssertionError(f"serve_reshard: no reshard to {RESHARD_TO} reported: {rc}")
    if rs_launches["dot_interaction"] < rs["batches"]:
        raise AssertionError(f"K2 launched {rs_launches['dot_interaction']} times "
                             f"for {rs['batches']} batches")
    log("[serve_reshard] " + json.dumps({
        "requests": rs["requests"], "batches": rs["batches"],
        "throughput_rps": rs["throughput_rps"], "p50_latency_ms": rs["p50_latency_ms"],
        "p99_latency_ms": rs["p99_latency_ms"], "chaos": rc,
        "phase_seconds": rs_seconds, "launches": rs_launches,
    }))
    del sparams, server, controller, engine, reqs, wl, chaos_reqs, cb
    del clean, faulty, again, injector, injector2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] DLRM state freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
        "allocated on the card")

    # ------------------------------------------------------------ lm kernels
    lm_cfg = serving_config(make_lm_config())
    Hq, Hkv, dh = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.d_head
    bf16, f32 = torch.bfloat16, torch.float32
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    lm_gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(shape, dtype):
        return torch.randn(shape, device=dev, generator=lm_gen).to(dtype)

    def k6_bound(q, k, causal, rate=None):
        B_, S_, H_, d_ = q.shape
        pairs = S_ * (S_ + 1) // 2 if causal else S_ * S_
        rate = rate or (BF16_TENSOR_FLOP_PER_S if q.dtype == bf16 else F32_FLOP_PER_S)
        return bound(2 * (q.numel() + k.numel()) * q.element_size(),  # q, k, v, out
                     4 * d_ * B_ * H_ * pairs, rate)

    def k7_bound(q, kc, n):
        B_, _, Hkv_, d_ = kc.shape
        return bound(2 * B_ * n * Hkv_ * d_ * kc.element_size()  # K and V rows < n
                     + 2 * q.numel() * q.element_size(),  # q, out
                     4 * d_ * q.shape[0] * q.shape[1] * n)

    def k6_lib(q, k, v, causal):  # the yardstick: timed here, never called by the port
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=causal,
                                              enable_gqa=True)

    def k7_lib(q, kc, vc, n):
        return F.scaled_dot_product_attention(q[:, :, None], kc[:, :n].transpose(1, 2),
                                              vc[:, :n].transpose(1, 2), enable_gqa=True)

    lm_rows = []

    def time_case(label, kern, plain, lib, bnd):
        row = {"case": label, "ms": cuda_ms(kern, flush),
               "plain_ms": None if plain is None else cuda_ms(plain, flush),
               "library_ms": cuda_ms(lib, flush), "bound_ms": bnd[0], "bound_by": bnd[1]}
        lm_rows.append(row)
        return row

    log("[lm_kernels] K6 and K7 against their plain versions on the card")
    B, S = LM_BATCH, LM_PROMPT
    k6_cases = {
        "path bf16": ((B, S, Hq, dh), Hkv, bf16, True),
        "path f32": ((B, S, Hq, dh), Hkv, f32, True),
        # lm_f32's own prefill layer: the full-depth check's 2 x 1,024 tokens.
        "lm_f32 f32": ((2, LM_DEPTH_PROMPT, Hq, dh), Hkv, f32, True),
        "gqa bf16": ((1, S, LM_GQA_HEADS[0], LM_GQA_HEADS[2]), LM_GQA_HEADS[1], bf16, True),
        "dh128 bf16": ((1, S, Hq, LM_GQA_HEADS[2]), Hq, bf16, True),
        "ragged bf16": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, bf16, True),
        "ragged dh64 bf16": ((2, LM_RAGGED_SEQ, 4, 64), 2, bf16, True),
        "ragged dh96 bf16": ((2, LM_RAGGED_SEQ, 4, 96), 2, bf16, True),
        "ragged full bf16": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, bf16, False),
        "ragged full f32": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, f32, False),
        # f32 (3xTF32 on mma.sync) at every head dim, with GQA, ragged S
        # causal and full.
        "gqa f32": ((1, S, LM_GQA_HEADS[0], LM_GQA_HEADS[2]), LM_GQA_HEADS[1], f32, True),
        "dh128 f32": ((1, S, Hq, LM_GQA_HEADS[2]), Hq, f32, True),
        "ragged f32": ((2, LM_RAGGED_SEQ, Hq, dh), Hkv, f32, True),
        "ragged dh64 f32": ((2, LM_RAGGED_SEQ, 4, 64), 2, f32, True),
        "ragged dh96 f32": ((2, LM_RAGGED_SEQ, 4, 96), 2, f32, True),
        "ragged dh128 full f32": ((2, LM_RAGGED_SEQ, 4, 128), 1, f32, False),
    }
    k6_f32 = {}  # f32 timing rows by label
    with torch.no_grad():
        for label, (shape, hkv, dt, causal) in k6_cases.items():
            q = rnd(shape, dt)
            k = rnd(shape[:2] + (hkv, shape[3]), dt)
            v = rnd(shape[:2] + (hkv, shape[3]), dt)
            check = assert_close_rows if dt == bf16 else assert_close
            tol = LM_BF16_TOL if dt == bf16 else LM_F32_TOL
            want = ref.flash_attention_ref(q, k, v, causal)
            err = check(f"K6 flash_attention {label} {list(shape[:3]) + [hkv, shape[3]]} "
                        f"{'causal' if causal else 'full'}",
                        K6.flash_attention(q, k, v, causal), want, *tol)
            if label in ("path bf16", "path f32"):
                # A kernel whose KV loop skips the first tile, seen only on
                # the later half of the rows, where |out| is smallest.
                t, h = LM_KV_TILE, S // 2
                planted = ref.flash_attention_ref(q[:, t:], k[:, t:], v[:, t:], True)
                refuse = assert_refused if dt == bf16 else assert_refused_close
                refuse(f"K6 {label} with the first KV tile skipped, rows {h}+",
                       planted[:, h - t:], want[:, h:], *tol)
                del planted
            if label == "path bf16":
                errs["flash_attention"] = err
                timings["flash_attention"] = (
                    cuda_ms(lambda: K6.flash_attention(q, k, v, True), flush),
                    cuda_ms(lambda: ref.flash_attention_ref(q, k, v, True), flush),
                    cuda_ms(lambda: k6_lib(q, k, v, True), flush))
                bounds["flash_attention"] = k6_bound(q, k, True)
            elif label in ("path f32", "lm_f32 f32", "gqa bf16", "dh128 bf16"):
                # f32's bound is its design's: three tf32 products; the f32
                # FMA bound stands beside it.
                rate = TF32_TENSOR_FLOP_PER_S / 3 if dt == f32 else None
                row = time_case(f"K6 {label} {list(shape[:3]) + [hkv, shape[3]]}",
                                lambda: K6.flash_attention(q, k, v, causal),
                                lambda: ref.flash_attention_ref(q, k, v, causal),
                                lambda: k6_lib(q, k, v, causal), k6_bound(q, k, causal, rate))
                if dt == f32:
                    row["bound_ms_fma"] = k6_bound(q, k, causal)[0]
                    row["max_abs_err"] = err
                    k6_f32[label] = row
            del q, k, v, want
        # K6 at prefill_32k's length, one sequence: kernel and library only.
        Sp = LM_SHAPES["prefill_32k"]["seq"]
        q, k, v = (rnd((1, Sp, Hq, dh), bf16) for _ in range(3))
        time_case(f"K6 bf16 [1, {Sp}, {Hq}, {Hkv}, {dh}] causal (prefill_32k, B = 1)",
                  lambda: K6.flash_attention(q, k, v, True), None,
                  lambda: k6_lib(q, k, v, True), k6_bound(q, k, True))
        del q, k, v

        n_path = LM_PROMPT + 1  # the first decode step's valid length
        # K7 splits the positions into chunks (K7.plan_split): cache_len on a
        # chunk boundary of the g = 4 case, one past it, and the whole cache.
        g4_q = (2, 4 * LM_GQA_HEADS[1], LM_GQA_HEADS[2])
        g4_c = (2, LM_CACHE, LM_GQA_HEADS[1], LM_GQA_HEADS[2])
        g4_bounds = K7.chunk_bounds(LM_CACHE, K7.plan_split(LM_CACHE, 2, g4_c[2], 4))
        edge = g4_bounds[len(g4_bounds) // 2]
        k7_cases = {
            "path bf16": ((B, Hq, dh), (B, LM_CACHE, Hkv, dh), bf16, n_path),
            "cache_len 1": ((B, Hq, dh), (B, LM_CACHE, Hkv, dh), bf16, 1),
            "path f32": ((B, Hq, dh), (B, LM_CACHE, Hkv, dh), f32, n_path),
            "gqa bf16": ((2, LM_GQA_HEADS[0], LM_GQA_HEADS[2]),
                         (2, LM_CACHE, LM_GQA_HEADS[1], LM_GQA_HEADS[2]), bf16, n_path),
            "g4 chunk edge bf16": (g4_q, g4_c, bf16, edge),
            "g4 chunk edge + 1 bf16": (g4_q, g4_c, bf16, edge + 1),
            "g4 full cache bf16": (g4_q, g4_c, bf16, LM_CACHE),
            "g4 chunk edge + 1 f32": (g4_q, g4_c, f32, edge + 1),
        }
        log(f"  K7 chunks: {K7.plan_split(LM_CACHE, B, Hkv, Hq // Hkv)} at the path shape, "
            f"{len(g4_bounds) - 1} at g = 4 (chunk edge {edge})")
        for label, (qs, cs, dt, n) in k7_cases.items():
            q, kc, vc = rnd(qs, dt), rnd(cs, dt), rnd(cs, dt)
            kc[:, n:] = float("nan")  # garbage past cache_len is never read
            vc[:, n:] = float("nan")
            n_t = torch.tensor(n, dtype=torch.int32, device=dev)
            got = K7.flash_decode(q, kc, vc, n_t)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"K7 {label}: output not finite with NaN past cache_len")
            check = assert_close_rows if dt == bf16 else assert_close
            tol = LM_BF16_TOL if dt == bf16 else LM_F32_TOL
            want = ref.flash_decode_ref(q, kc, vc, n_t)
            err = check(f"K7 flash_decode {label} q {list(qs)} caches {list(cs)} "
                        f"cache_len {n}, NaN past it", got, want, *tol)
            if label == "path bf16":
                assert_refused(f"K7 {label} with the last KV tile skipped",
                               ref.flash_decode_ref(q, kc, vc, n_t - LM_KV_TILE), want, *tol)
                # A combine that drops the middle chunk of the split.
                bnd = K7.chunk_bounds(cs[1], K7.plan_split(cs[1], cs[0], cs[2], qs[1] // cs[2]))
                lo, hi = bnd[(len(bnd) - 1) // 2], bnd[(len(bnd) - 1) // 2 + 1]
                keep = torch.cat([torch.arange(lo, device=dev),
                                  torch.arange(hi, cs[1], device=dev)])
                assert_refused(f"K7 {label} with chunk [{lo}, {hi}) dropped",
                               ref.flash_decode_ref(q, kc[:, keep], vc[:, keep],
                                                    n - (hi - lo)), want, *tol)
                del keep
                errs["flash_decode"] = err
                timings["flash_decode"] = (
                    cuda_ms(lambda: K7.flash_decode(q, kc, vc, n_t), flush),
                    cuda_ms(lambda: ref.flash_decode_ref(q, kc, vc, n_t), flush),
                    cuda_ms(lambda: k7_lib(q, kc, vc, n), flush))
                bounds["flash_decode"] = k7_bound(q, kc, n)
            elif label in ("path f32", "gqa bf16"):
                time_case(f"K7 {label} q {list(qs)} caches {list(cs)} cache_len {n}",
                          lambda: K7.flash_decode(q, kc, vc, n_t),
                          lambda: ref.flash_decode_ref(q, kc, vc, n_t),
                          lambda: k7_lib(q, kc, vc, n), k7_bound(q, kc, n))
            del q, kc, vc, got, want
        # K7 at decode_32k's length, B = 8, a full cache: kernel and library only.
        Bl, Sl = LM_LONG_DECODE_BATCH, LM_SHAPES["decode_32k"]["seq"]
        q = rnd((Bl, Hq, dh), bf16)
        kc, vc = rnd((Bl, Sl, Hkv, dh), bf16), rnd((Bl, Sl, Hkv, dh), bf16)
        n_t = torch.tensor(Sl, dtype=torch.int32, device=dev)
        time_case(f"K7 bf16 q [{Bl}, {Hq}, {dh}] caches [{Bl}, {Sl}, {Hkv}, {dh}] cache_len "
                  f"{Sl} (decode_32k, B = {Bl})", lambda: K7.flash_decode(q, kc, vc, n_t),
                  None, lambda: k7_lib(q, kc, vc, Sl), k7_bound(q, kc, Sl))
        del q, kc, vc
    for name in ("flash_attention", "flash_decode"):
        ms, plain_ms, lib_ms = timings[name]
        bms, by = bounds[name]
        log(f"  {name} at the path shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bms:.6f} ms (by {by}; the kernel reaches "
            f"{bms / ms:.1%} of it)")
    log("[lm_kernels] " + json.dumps(lm_rows))
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ lm_prefill
    t0 = time.perf_counter()
    lm_params = TF.init_params(lm_cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[lm_prefill] {lm_cfg.name}: {lm_cfg.num_params():,} parameters in bf16 "
        f"({tree_size_bytes(lm_params) / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    host_lm = syn.lm_batch(np.random.default_rng(0), lm_cfg.vocab, LM_BATCH, LM_PROMPT)
    tokens = torch.from_numpy(host_lm["tokens"]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        last, (kc, vc) = TF.prefill(lm_cfg, lm_params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = launch_counts()
    if prefill_launches["flash_attention"] != lm_cfg.n_layers:
        raise AssertionError(f"lm_prefill launched K6 {prefill_launches['flash_attention']} "
                             f"times, want one per layer ({lm_cfg.n_layers})")
    Vp = lm_cfg.padded_vocab()
    if last.shape != (LM_BATCH, Vp) or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"lm_prefill last logits not finite [{LM_BATCH}, {Vp}]: "
                             f"{tuple(last.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: TF.prefill(lm_cfg, lm_params, tokens), flush,
                             reps=5, warmup=1)
        prefill_busy = device_busy(lambda: TF.prefill(lm_cfg, lm_params, tokens), 1)
    log("[lm_prefill] " + json.dumps({
        "model": lm_cfg.name, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "first_call_wall_ms": prefill_s * 1e3, "device_median_ms": prefill_ms,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / (prefill_ms / 1e3),
        "peak_memory_gb": peak_gb, "launches": prefill_launches,
        "profile": prefill_busy,
    }))

    # ------------------------------------------------------------- lm_decode
    k_cache, v_cache = TF.init_decode_cache(lm_cfg, LM_BATCH, LM_CACHE, device=dev)
    k_cache[:, :, :LM_PROMPT] = kc
    v_cache[:, :, :LM_PROMPT] = vc
    del kc, vc
    tok = last[:, :lm_cfg.vocab].argmax(-1).to(torch.int32)
    pos = torch.tensor(LM_PROMPT, dtype=torch.int32, device=dev)
    step_events, generated = [], []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(LM_DECODE_STEPS):  # no host sync inside the loop
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, (k_cache, v_cache) = TF.decode_step(lm_cfg, lm_params,
                                                        (k_cache, v_cache), tok, pos)
            end.record()
            step_events.append((start, end))
            tok = logits[:, :lm_cfg.vocab].argmax(-1).to(torch.int32)
            generated.append(tok)
            pos += 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = launch_counts()
    want_launches = lm_cfg.n_layers * LM_DECODE_STEPS
    if decode_launches["flash_decode"] != want_launches:
        raise AssertionError(f"lm_decode launched K7 {decode_launches['flash_decode']} "
                             f"times, want {want_launches}")
    if logits.shape != (LM_BATCH, Vp) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_decode logits not finite: {tuple(logits.shape)}")
    if int(pos) != LM_PROMPT + LM_DECODE_STEPS:
        raise AssertionError(f"lm_decode ended at position {int(pos)}")
    step_ms = [s_.elapsed_time(e_) for s_, e_ in step_events]
    # Two more steps under the profiler, at the first two positions again.
    pos.fill_(LM_PROMPT)

    def step():
        tok_ = TF.decode_step(lm_cfg, lm_params, (k_cache, v_cache), tok, pos)[0]
        pos.add_(1)
        return tok_

    with torch.no_grad():
        decode_busy = device_busy(step, 2)
    log("[lm_decode] " + json.dumps({
        "model": lm_cfg.name, "batch": LM_BATCH, "cache": LM_CACHE,
        "steps": LM_DECODE_STEPS, "wall_s": decode_s,
        "step_wall_median_ms": statistics.median(step_ms),
        "step_wall_ms_min_max": [min(step_ms), max(step_ms)],
        "step_device_busy_ms": decode_busy["device_busy_ms"],
        "decode_tokens_per_s": LM_BATCH * LM_DECODE_STEPS / decode_s,
        "first_tokens_generated": torch.stack(generated[:4], 1).tolist(),
        "launches": decode_launches, "profile": decode_busy,
    }))
    del k_cache, v_cache, logits, last, tokens
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- lm_checks
    def prefill_then_decode(cfg_, params_, toks, prompt, device):
        """Last prefill logits, then each teacher-forced decode step's, and
        the caches after the steps."""
        toks = toks.to(device)
        steps = toks.shape[1] - prompt
        with torch.no_grad():
            last_, (kc_, vc_) = TF.prefill(cfg_, params_, toks[:, :prompt])
            kd, vd = TF.init_decode_cache(cfg_, toks.shape[0], prompt + steps, device=device)
            kd[:, :, :prompt] = kc_
            vd[:, :, :prompt] = vc_
            outs = [last_]
            for i in range(steps):
                p_ = torch.tensor(prompt + i, dtype=torch.int32, device=device)
                outs.append(TF.decode_step(cfg_, params_, (kd, vd), toks[:, prompt + i], p_)[0])
        return torch.stack(outs), kd, vd

    log("[lm_checks] f32 compute, TF32 off")
    reset_counts()  # the lm_f32 path (the CPU's half takes the plain versions)
    cut_cfg = dataclasses.replace(lm_cfg, n_layers=LM_CUT_LAYERS, compute_dtype=f32)
    cut_params = dict(lm_params, layers={k: v[:LM_CUT_LAYERS]
                                         for k, v in lm_params["layers"].items()})
    cut_toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(1), lm_cfg.vocab, 2,
                                             LM_CUT_PROMPT + LM_CHECK_STEPS)["tokens"])
    on_card = prefill_then_decode(cut_cfg, cut_params, cut_toks, LM_CUT_PROMPT, dev)
    on_cpu = prefill_then_decode(cut_cfg, tree_to(cut_params, "cpu"), cut_toks,
                                 LM_CUT_PROMPT, "cpu")
    for what, got, want in zip(("logits", "k cache", "v cache"), on_card, on_cpu):
        assert_close(f"lm {LM_CUT_LAYERS}-layer cut, full width, prefill {LM_CUT_PROMPT} + "
                     f"{LM_CHECK_STEPS} decode steps: {what} on the card (K6/K7) vs the CPU "
                     "(plain versions)", got.cpu(), want, 1e-4, 1e-4)
    del on_card, on_cpu, cut_params
    deep_cfg = dataclasses.replace(lm_cfg, compute_dtype=f32)
    deep_toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(2), lm_cfg.vocab, 2,
                                              LM_DEPTH_PROMPT + LM_CHECK_STEPS)["tokens"])
    stepped = prefill_then_decode(deep_cfg, lm_params, deep_toks, LM_DEPTH_PROMPT, dev)[0]
    with torch.no_grad():
        full = TF.forward(deep_cfg, lm_params, deep_toks.to(dev))[0]
    lm_f32_launches = launch_counts()
    require("lm_f32", lm_f32_launches, ("flash_attention", "flash_attention_f32",
                                        "flash_decode"))
    if lm_f32_launches["flash_attention_f32"] != lm_f32_launches["flash_attention"]:
        raise AssertionError(f"lm_f32 launched K6 outside f32: {lm_f32_launches}")
    want = full[:, LM_DEPTH_PROMPT - 1:].transpose(0, 1)  # [steps + 1, B, Vp]
    assert_close(f"lm full depth f32: prefill {LM_DEPTH_PROMPT} + {LM_CHECK_STEPS} decode "
                 f"steps vs one forward over {LM_DEPTH_PROMPT + LM_CHECK_STEPS} tokens",
                 stepped, want, 1e-3, 1e-3)
    del stepped, full, want, lm_params
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- kernels line
    sources = {
        "embedding_bag": "src/repro/kernels/embedding_bag.py:38",
        "dot_interaction": "src/repro/kernels/dot_interaction.py:28",
        "probe_gather_pool": "src/repro/hotcache/kernels.py:64",
        "scatter_update": "src/repro/hotcache/kernels.py:122",
        "topk_neighbor_select": "src/repro/prefetch/kernels.py:66",
        "flash_attention": "src/repro/kernels/flash_attention.py:76",
        "flash_decode": "src/repro/kernels/flash_decode.py:69",
    }
    paths = {"forward": fwd_launches, "serve": srv_launches,
             "cached_forward": cached_launches, "serve_prefetch": pf_launches,
             "serve_open_loop": ol_launches, "serve_chaos": chaos_launches,
             "serve_reshard": rs_launches,
             "lm_prefill": prefill_launches, "lm_decode": decode_launches,
             "lm_f32": lm_f32_launches}
    kernels = []
    for name, replaces in sources.items():
        ms, plain_ms, lib_ms = timings[name]
        bms, by = bounds[name]
        by_path = {p: c[name] for p, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "ok": True,
        })
        if name in read_flushed:
            kernels[-1]["ms_read_flush"] = read_flushed[name]
        if name == "embedding_bag":  # timed in the masked mode, the main path's
            kernels[-1].update({
                "mode": "masked", "bound_ms_weighted": k1_weighted["bound_ms"],
                "masked_launches_by_path": {p: c["embedding_bag_masked"]
                                            for p, c in paths.items()},
                "weighted": k1_weighted,
            })
        if name == "flash_attention":  # timed in bf16 (lm_prefill's); f32 beside it
            f32_keys = ("case", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                        "bound_ms_fma", "max_abs_err")
            kernels[-1]["f32"] = {  # at lm_f32's shape, then at lm_prefill's
                **{key: k6_f32["lm_f32 f32"][key] for key in f32_keys},
                "launches_by_path": {p: c["flash_attention_f32"] for p, c in paths.items()},
                "prefill_shape": {key: k6_f32["path f32"][key] for key in f32_keys},
            }
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
