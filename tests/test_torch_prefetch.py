"""repro_torch's co-occurrence prefetcher (prefetch/, kernel K5 and the
server's piggyback) against the JAX package, on the CPU.

On the CPU the miner selects neighbors with K5's plain version
(prefetch/ref.py); chip_smoke.py holds the CUDA kernel against it on the
card.  Tolerances:
  * bit-equal: top-k values and indices, the miner's lists and scores, the
    tier's per-batch outputs and stats, the server's prefetch counters;
  * server scores rtol 1e-4, atol 1e-5 (BLAS summation order).
"""
import contextlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adaptive_cache import AdaptiveCacheController as JaxController
from repro.core.adaptive_cache import MemoryModel as JaxMemoryModel
from repro.core.lookup_engine import HostLookupService as JaxHostService
from repro.core.sharding import TableSpec as JaxTableSpec
from repro.core.sharding import make_fused_tables as jax_fused_tables
from repro.data.pipeline import BucketBatcher as JaxBatcher
from repro.hotcache.miss_path import TieredLookupService as JaxTiered
from repro.hotcache.policy import AdmissionPolicy as JaxAdmissionPolicy
from repro.models import recsys as JR
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.prefetch import CooccurrenceMiner as JaxMiner
from repro.prefetch import PrefetchEngine as JaxEngine
from repro.prefetch import PrefetchPolicy as JaxPolicy
from repro.prefetch import topk_neighbor_select as jax_topk
from repro.prefetch import topk_neighbor_select_ref as jax_topk_ref
from repro.prefetch import topk_select_np as jax_topk_np
from repro.runtime.serving import FlexEMRServer as JaxServer
from repro_torch.core.adaptive_cache import AdaptiveCacheController, MemoryModel
from repro_torch.core.lookup_engine import HostLookupService
from repro_torch.core.sharding import TableSpec, make_fused_tables
from repro_torch.data.pipeline import BucketBatcher
from repro_torch.data.synthetic import CooccurrenceWorkload
from repro_torch.hotcache.miss_path import TieredLookupService
from repro_torch.hotcache.policy import AdmissionPolicy
from repro_torch.kernels import build
from repro_torch.models import recsys as R
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.prefetch import (
    CooccurrenceMiner,
    PrefetchEngine,
    PrefetchPolicy,
    topk_neighbor_select,
    topk_neighbor_select_ref,
    topk_select_np,
)
from repro_torch.prefetch import kernels as PK
from repro_torch.runtime.serving import FlexEMRServer


# ------------------------------------------------------------------ K5 top-k


def _tied_scores(rng, M, L, dtype=np.float32):
    """Normal scores with ~25% -inf, exact ties in row 0 and an all -inf
    last row."""
    s = rng.normal(size=(M, L)).astype(dtype)
    s[rng.random((M, L)) < 0.25] = -np.inf
    s[0, : min(4, L)] = 1.5
    s[-1, :] = -np.inf
    return s


@pytest.mark.parametrize("M,L,k", [(4, 8, 3), (16, 100, 8), (3, 128, 128), (8, 200, 1)])
def test_topk_select_bit_equal_with_reference(M, L, k, rng):
    scores = _tied_scores(rng, M, L)
    gv, gi = topk_neighbor_select(torch.from_numpy(scores), k)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert gv.shape == gi.shape == (M, k)
    for wv, wi in (jax_topk(jnp.asarray(scores), k, interpret=True),
                   jax_topk_ref(jnp.asarray(scores), k), jax_topk_np(scores, k),
                   topk_select_np(scores, k)):
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    rv, ri = topk_neighbor_select_ref(torch.from_numpy(scores), k)
    assert torch.equal(rv, gv) and torch.equal(ri, gi)
    np.testing.assert_array_equal(gi[-1].numpy(), np.arange(k))  # -inf row: in order


def test_topk_select_f64_keeps_distinct_scores_apart(rng):
    """f64 scores that round to one f32 value: the port selects on f64, as
    the miner's numpy twin does."""
    scores = _tied_scores(rng, 6, 16, np.float64)
    scores[1, 3] = 1.0 + 1e-12  # == 1.0 in f32, larger in f64
    scores[1, 2] = 1.0
    gv, gi = topk_neighbor_select(torch.from_numpy(scores), 5)
    assert gv.dtype == torch.float64
    wv, wi = topk_select_np(scores, 5)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)


def _edge_scores(rng, M, L, dtype):
    """Scores on a grid of 1/4 with -inf, NaN, -0.0 and +0.0 scattered in,
    an all-NaN row and an all -inf last row (chip_smoke.py's K5 inputs)."""
    s = np.round(rng.normal(size=(M, L)) * 4) / 4
    u = rng.random((M, L))
    s[u < 0.2] = -np.inf
    s[(u >= 0.2) & (u < 0.3)] = np.nan
    s[(u >= 0.3) & (u < 0.4)] = -0.0
    s[(u >= 0.4) & (u < 0.5)] = 0.0
    s[-2] = np.nan
    s[-1] = -np.inf
    return s.astype(dtype)


def _sort_keys(s: np.ndarray) -> np.ndarray:
    """K5's sort_key: an unsigned key whose order is the selection order
    (a larger key first; NaN 0, below -inf; -0.0 as +0.0)."""
    u = {np.float32: np.uint32, np.float64: np.uint64}[s.dtype.type]
    sign = u(1) << u(8 * s.itemsize - 1)
    bits = np.where(s == 0, np.zeros((), s.dtype), s).view(u)
    keys = np.where(bits & sign, ~bits, bits | sign)
    return np.where(np.isnan(s), u(0), keys)


def _rank_select(s: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """K5's rank select in numpy: column c's rank is the number of columns
    before it (a larger key, or an equal key at a lower column); the column
    of rank r < k is output r."""
    key = _sort_keys(s)
    col = np.arange(s.shape[1])
    before = (key[:, :, None] > key[:, None, :]) | (
        (key[:, :, None] == key[:, None, :]) & (col[:, None] < col[None, :]))
    rank = before.sum(1)  # [M, L]: columns j before column c
    vals = np.empty((s.shape[0], k), s.dtype)
    idx = np.empty((s.shape[0], k), np.int32)
    rows, cols = np.nonzero(rank < k)
    vals[rows, rank[rows, cols]] = s[rows, cols]
    idx[rows, rank[rows, cols]] = cols
    return vals, idx


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("L", [1, 15, 16, 17, 31, 32, 33, 128])
def test_rank_select_order_bit_equal_with_reference(L, dtype, rng):
    """The kernel's rank order, emulated, against the plain version and the
    numpy twin at the kernel's row-plan edges, with NaN, signed zeros, ties
    and all -inf / all-NaN rows: values bit for bit, indices equal."""
    s = _edge_scores(rng, 40, L, dtype)
    for k in sorted({1, L}):
        gv, gi = _rank_select(s, k)
        rv, ri = topk_neighbor_select_ref(torch.from_numpy(s), k)
        nv, ni = topk_select_np(s, k)
        np.testing.assert_array_equal(gi, ri.numpy())
        np.testing.assert_array_equal(gi, ni)
        assert gv.tobytes() == rv.numpy().tobytes() == nv.tobytes()
    np.testing.assert_array_equal(gi[-1], np.arange(L))  # all -inf: in order
    np.testing.assert_array_equal(gi[-2], np.arange(L))  # all NaN: in order


class _FakeTopkLib:
    """K5's library, recording each launch's symbol and arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, sym):
        if not sym.startswith(PK.NAME):
            raise AttributeError(sym)
        return lambda *args: self.calls.append((sym, args)) or 0


@pytest.mark.parametrize("dtype,sym", [(torch.float32, "topk_neighbor_select_f32"),
                                       (torch.float64, "topk_neighbor_select_f64")])
def test_topk_wrapper_launch_arguments(monkeypatch, dtype, sym):
    """The CUDA branch of the K5 wrapper with the library and the CUDA calls
    faked: the scores' and outputs' pointers, M, L, k and the stream; the
    outputs [M, k] in the scores' dtype and int32; one launch counted."""
    lib = _FakeTopkLib()
    monkeypatch.setattr(PK, "_is_cuda", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=99))
    before = PK.launches
    scores = torch.zeros(64, 16, dtype=dtype)
    vals, idx = PK.topk_neighbor_select(scores, 12)
    ((got_sym, a),) = lib.calls
    assert got_sym == sym
    assert a == (scores.data_ptr(), vals.data_ptr(), idx.data_ptr(), 64, 16, 12, 99)
    assert vals.shape == idx.shape == (64, 12)
    assert vals.dtype == dtype and idx.dtype == torch.int32
    assert PK.launches == before + 1
    PK.topk_neighbor_select(torch.zeros(0, 16, dtype=dtype), 3)  # nothing to launch
    assert len(lib.calls) == 1 and PK.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        PK.topk_neighbor_select(torch.zeros(16, 64, dtype=dtype).T, 3)
    with pytest.raises(ValueError, match="exceeds"):
        PK.topk_neighbor_select(scores, 17)
    PK.launches = before


def test_topk_select_rejects_k_too_large():
    with pytest.raises(ValueError):
        topk_neighbor_select(torch.zeros(2, 4), 5)
    with pytest.raises(ValueError):
        topk_neighbor_select_ref(torch.zeros(2, 4, dtype=torch.float64), 5)


# ---------------------------------------------------------------------- miner


SPECS = (("hist", 40_000, 8), ("item", 10_000, 4))


def _workload(**kw):
    return CooccurrenceWorkload(
        tuple(TableSpec(n, v, nnz=k) for n, v, k in SPECS), **kw)


def test_miner_state_bit_equal_with_reference():
    wl = _workload(batch=32, alpha=1.05, cooccur_frac=0.7, pool_size=64, seed=4)
    kw = dict(list_len=8, max_rows=512, decay=0.9, seed=1)
    jm, tm = JaxMiner(**kw), CooccurrenceMiner(**kw, device="cpu")
    offsets = np.array([0, 40_000])
    for step in range(10):
        b = wl.next_batch()
        fused = b["indices"].astype(np.int64) + offsets[None, :, None]
        jm.observe(fused, b["mask"])
        tm.observe(fused, b["mask"])
        if step % 3 == 2:
            jm.decay()
            tm.decay()
    np.testing.assert_array_equal(tm._nbr, jm._nbr)
    np.testing.assert_array_equal(tm._score, jm._score)
    assert tm.tracked_rows == jm.tracked_rows > 0
    ids = np.concatenate([tm._row_ids[:40], [123_456_789]])
    for k, floor in ((3, 0.0), (8, 1.0), (12, 0.5)):
        want_ids, want_sc = jm.neighbors(ids, k, floor)
        got_ids, got_sc = tm.neighbors(ids, k, floor)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_sc, want_sc)
    assert (got_ids >= 0).any()


def test_neighbors_copies_back_once(monkeypatch):
    """``neighbors`` brings the selection back in one copy (values and
    indices side by side), with results bit-equal to the reference miner."""
    wl = _workload(batch=32, alpha=1.05, cooccur_frac=0.7, pool_size=64, seed=5)
    kw = dict(list_len=16, max_rows=512, decay=0.9, seed=2)
    jm, tm = JaxMiner(**kw), CooccurrenceMiner(**kw, device="cpu")
    offsets = np.array([0, 40_000])
    for _ in range(6):
        b = wl.next_batch()
        fused = b["indices"].astype(np.int64) + offsets[None, :, None]
        jm.observe(fused, b["mask"])
        tm.observe(fused, b["mask"])
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **kw: copies.append(self.shape) or real_cpu(self, *a, **kw))
    ids = tm._row_ids[:64]
    got = tm.neighbors(ids, 12, 1.0)
    assert len(copies) == 1
    want = jm.neighbors(ids, 12, 1.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()
    assert (got[0] >= 0).any()


# --------------------------------------------------- tier with a prefetcher


def _serve_tier(svc_cls, tier_cls, policy_cls, tables, table_np, batches, engine):
    svc = svc_cls(tables, table_np)
    tiered = tier_cls(svc, num_slots=4096,
                      policy=policy_cls(admission_threshold=3.0, max_swap_in=1024),
                      refresh_every=2, prefetcher=engine)
    try:
        outs = [tiered.lookup(b["indices"], b["mask"]) for b in batches]
    finally:
        svc.close()
    return tiered, outs


def test_tier_with_prefetcher_bit_equal_with_reference(rng):
    """The tier + PrefetchEngine of tests/test_prefetch.py's ``_serve``, in
    both packages on the same batches: per-batch outputs and TieredStats
    bit-equal."""
    dim, shards = 32, 4
    table_np = rng.normal(0, 0.01, size=(50_000, dim)).astype(np.float32)
    jtables = jax_fused_tables(tuple(JaxTableSpec(n, v, nnz=k) for n, v, k in SPECS),
                               dim, shards)
    ttables = make_fused_tables(tuple(TableSpec(n, v, nnz=k) for n, v, k in SPECS),
                                dim, shards)
    table_np = np.resize(table_np, (ttables.total_rows, dim))
    wl = _workload(batch=48, alpha=1.03, cooccur_frac=0.7, pool_size=128,
                   drift_every=6, seed=11)
    batches = [wl.next_batch() for _ in range(12)]
    miner_kw = dict(list_len=16, max_rows=16_384, decay=0.99)
    policy_kw = dict(k_neighbors=12, byte_budget=1 << 18, min_score=1.0)
    jt, jouts = _serve_tier(JaxHostService, JaxTiered, JaxAdmissionPolicy, jtables,
                            table_np, batches,
                            JaxEngine(JaxMiner(**miner_kw), JaxPolicy(**policy_kw)))
    tt, touts = _serve_tier(HostLookupService, TieredLookupService, AdmissionPolicy,
                            ttables, table_np, batches,
                            PrefetchEngine(CooccurrenceMiner(**miner_kw, device="cpu"),
                                           PrefetchPolicy(**policy_kw)))
    for a, b in zip(jouts, touts):
        np.testing.assert_array_equal(b, a)
    assert tt.stats.summary() == jt.stats.summary()
    assert tt.stats.prefetch_issued > 0  # the piggyback channel ran


# ------------------------------------------------------- server with prefetch


TABLES = (("big", 40_000, 4), ("mid", 10_000, 2), ("s0", 300, 1), ("s1", 300, 1),
          ("s2", 300, 1))
CFG_KW = dict(name="t", arch="dlrm", embed_dim=16, n_dense=13, bottom_mlp=(64, 16),
              mlp=(64, 32))
MEM_KW = dict(fixed_bytes=1 << 20, bytes_per_sample=1 << 10, hbm_bytes=1 << 28)
# The batchers' deadline: longer than any pause of a loaded worker, so a
# pre-filled queue always yields full batches of 8 (poll returns at 8).
BATCH_WAIT_S = 5.0
CTL_KW = dict(field_replication=False, max_rows=128, prefetch_frac=0.5)
ENGINE_KW = (dict(list_len=8, max_rows=4096, decay=0.99),
             dict(k_neighbors=8, byte_budget=1 << 16, min_score=1.0))


def _serve_server(server, reqs):
    try:
        for r in reqs:
            server.submit(r)
        outs = []
        while server.metrics.requests < len(reqs):
            o = server.step()
            if o is not None:
                outs.append(o["scores"])
        return outs, server.metrics.summary()
    finally:
        server.close()


def test_server_with_prefetcher_matches_reference():
    """tests/test_prefetch.py's serving setup in both packages (closed loop,
    fixed 8-request batches), with a 128-row cache plan: the piggyback rides
    the plan swap-in only when the co-occurring partners of newly planned
    rows are not resident yet, which needs a plan smaller than the working
    set.  Scores allclose, prefetch counters and hit rate equal."""
    jcfg = JR.RecsysConfig(
        tables=tuple(JaxTableSpec(n, v, nnz=k) for n, v, k in TABLES), **CFG_KW)
    tcfg = R.RecsysConfig(
        tables=tuple(TableSpec(n, v, nnz=k) for n, v, k in TABLES), **CFG_KW)
    np_params = jax.tree_util.tree_map(np.asarray, JR.init_params(jcfg, jax.random.key(2)))
    wl = CooccurrenceWorkload(tcfg.tables, batch=1, alpha=1.1, cooccur_frac=0.8,
                              pool_size=32, n_dense=13, seed=3)
    reqs = []
    for _ in range(128):
        b = wl.next_batch()
        reqs.append({"indices": b["indices"][0], "mask": b["mask"][0],
                     "dense": b["dense"][0]})
    common = dict(cache_refresh_every=4, pipeline_depth=1, hedge_timeout=None)
    jserver = JaxServer(
        jcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
        jax_fused_tables(jcfg.tables, jcfg.embed_dim, 4),
        controller=JaxController(jcfg.tables, jcfg.embed_dim, JaxMemoryModel(**MEM_KW),
                                 **CTL_KW),
        prefetcher=JaxEngine(JaxMiner(**ENGINE_KW[0]), JaxPolicy(**ENGINE_KW[1])),
        batcher=JaxBatcher(buckets=(8,), max_wait=BATCH_WAIT_S), registry=JaxRegistry(),
        **common)
    tserver = FlexEMRServer(
        tcfg, R.params_from_numpy(np_params, "cpu"),
        make_fused_tables(tcfg.tables, tcfg.embed_dim, 4),
        controller=AdaptiveCacheController(tcfg.tables, tcfg.embed_dim,
                                           MemoryModel(**MEM_KW), **CTL_KW),
        prefetcher=PrefetchEngine(CooccurrenceMiner(**ENGINE_KW[0], device="cpu"),
                                  PrefetchPolicy(**ENGINE_KW[1])),
        batcher=BucketBatcher(buckets=(8,), max_wait=BATCH_WAIT_S), registry=MetricsRegistry(),
        device="cpu", **common)
    j_outs, j_sum = _serve_server(jserver, reqs)
    t_outs, t_sum = _serve_server(tserver, reqs)
    assert len(t_outs) == len(j_outs) == 16
    for a, b in zip(j_outs, t_outs):
        assert np.all(np.isfinite(b))
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    keys = ("prefetch_issued", "bytes_prefetch", "prefetch_hits", "hit_rate",
            "requests", "batches")
    assert {k: t_sum[k] for k in keys} == {k: j_sum[k] for k in keys}
    assert t_sum["prefetch_issued"] > 0
    assert "prefetch.issued" in tserver.registry.snapshot()


# ---------------------------------------------------- wrappers and devices


def test_cpu_tensors_never_launch():
    before = PK.launches
    topk_neighbor_select(torch.randn(4, 16, dtype=torch.float64), 3)
    assert PK.launches == before


def test_bound_symbols_exist_in_source():
    src = (build.CSRC / f"{PK.NAME}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(PK._SYMBOLS.values()) | {f"{PK.NAME}_error_string"} <= exported
    assert re.fullmatch(rf"lib{PK.NAME}-[0-9a-f]{{16}}\.so",
                        build.library_path(PK.NAME).name)


def test_miner_defaults_to_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        CooccurrenceMiner(list_len=4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PrefetchEngine()
