"""The port's serving slice as a whole against the JAX package's.

The tiny DLRM and the 48 seeded requests of tests/test_pipeline.py go through
``repro.runtime.serving.FlexEMRServer`` and ``repro_torch``'s, each with its
own metrics registry and the same live adaptive-cache controller:
  * the host tier's pooled sums are bit-equal (the same numpy f64 code);
  * per-batch scores are allclose (rtol 1e-4, atol 1e-5: BLAS summation
    order over the dense stage's five layers);
  * hit rate and the wire-byte accounting are equal;
  * within the port, scores are bit-equal across pipeline depth {1, 2} x
    hedge {off, forced}.
"""
import jax
import numpy as np
import pytest

from repro.core.adaptive_cache import AdaptiveCacheController as JaxController
from repro.core.adaptive_cache import MemoryModel as JaxMemoryModel
from repro.core.sharding import TableSpec as JaxTableSpec
from repro.core.sharding import make_fused_tables as jax_fused_tables
from repro.data.pipeline import BucketBatcher as JaxBatcher
from repro.models import recsys as JR
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.runtime.serving import FlexEMRServer as JaxServer
from repro_torch.core.adaptive_cache import AdaptiveCacheController, MemoryModel
from repro_torch.core.sharding import TableSpec, make_fused_tables
from repro_torch.data import synthetic as syn
from repro_torch.data.pipeline import BucketBatcher
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recsys as R
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.serving import FlexEMRServer

TABLES = (("big", 4000, 4), ("mid", 1000, 2), ("small", 64, 1))
CFG_KW = dict(name="t", arch="dlrm", embed_dim=16, n_dense=13,
              bottom_mlp=(64, 16), mlp=(64, 32))
MEM_KW = dict(fixed_bytes=1 << 20, bytes_per_sample=1 << 10, hbm_bytes=1 << 28)
SUMMARY_KEYS = ("requests", "batches", "hit_rate", "network_bytes",
                "bytes_no_cache", "bytes_request", "bytes_swap_in")


def _serve(server, reqs):
    """Serve ``reqs``; returns per-batch scores and every batch's tier
    handle (its f64 sums and f32 merge stay readable after retire)."""
    pendings = []
    begin = server._tiered.lookup_begin

    def recording_begin(indices, mask):
        p = begin(indices, mask)
        pendings.append(p)
        return p

    server._tiered.lookup_begin = recording_begin
    try:
        for r in reqs:
            server.submit(r)
        outs = []
        while True:
            o = server.step()
            if o is None and server.metrics.requests >= len(reqs):
                break
            if o is not None:
                outs.append(o["scores"])
        summary = server.metrics.summary()
    finally:
        server.close()
    assert summary["requests"] == len(reqs)
    return outs, pendings, summary


@pytest.fixture(scope="module")
def stream():
    jcfg = JR.RecsysConfig(
        tables=tuple(JaxTableSpec(n, v, nnz=k) for n, v, k in TABLES), **CFG_KW)
    tcfg = R.RecsysConfig(
        tables=tuple(TableSpec(n, v, nnz=k) for n, v, k in TABLES), **CFG_KW)
    np_params = jax.tree_util.tree_map(
        np.asarray, JR.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(3)
    reqs = []
    for _ in range(48):
        b = syn.recsys_batch(rng, tcfg.tables, 1, n_dense=tcfg.n_dense)
        reqs.append({"indices": b["indices"][0], "mask": b["mask"][0],
                     "dense": b["dense"][0]})
    jserver = JaxServer(
        jcfg, jax.tree_util.tree_map(jax.numpy.asarray, np_params),
        jax_fused_tables(jcfg.tables, jcfg.embed_dim, 4),
        controller=JaxController(jcfg.tables, jcfg.embed_dim, JaxMemoryModel(**MEM_KW),
                                 field_replication=False, max_rows=1024),
        cache_refresh_every=3, pipeline_depth=1, hedge_timeout=None,
        batcher=JaxBatcher(buckets=(8,), max_wait=0.001), registry=JaxRegistry(),
    )
    return tcfg, np_params, reqs, _serve(jserver, reqs)


def _port_run(stream, depth, hedge):
    tcfg, np_params, reqs, _ = stream
    server = FlexEMRServer(
        tcfg, R.params_from_numpy(np_params, "cpu"),
        make_fused_tables(tcfg.tables, tcfg.embed_dim, 4),
        controller=AdaptiveCacheController(
            tcfg.tables, tcfg.embed_dim, MemoryModel(**MEM_KW),
            field_replication=False, max_rows=1024),
        cache_refresh_every=3, pipeline_depth=depth, hedge_timeout=hedge,
        batcher=BucketBatcher(buckets=(8,), max_wait=0.001),
        registry=MetricsRegistry(), device="cpu",
    )
    return _serve(server, reqs)


@pytest.fixture(scope="module")
def port_ref(stream):
    return _port_run(stream, 1, None)


def test_port_matches_reference_server(stream, port_ref):
    j_outs, j_pend, j_sum = stream[3]
    t_outs, t_pend, t_sum = port_ref
    assert len(t_outs) == len(j_outs) == 6
    for a, b in zip(j_pend, t_pend):
        np.testing.assert_array_equal(a._sums, b._sums)  # f64 tier sums
        np.testing.assert_array_equal(a.wait(), b.wait())  # f32 merge
    for a, b in zip(j_outs, t_outs):
        assert b.dtype == np.float32 and np.all(np.isfinite(b))
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    assert {k: t_sum[k] for k in SUMMARY_KEYS} == {k: j_sum[k] for k in SUMMARY_KEYS}
    assert t_sum["hit_rate"] > 0  # the controller's cache plans took effect


@pytest.mark.parametrize("depth,hedge", [(2, None), (1, 0.0), (2, 0.0)])
def test_port_scores_bit_equal_across_depth_and_hedge(stream, port_ref, depth, hedge):
    outs, _, summary = _port_run(stream, depth, hedge)
    assert len(outs) == len(port_ref[0])
    for a, b in zip(outs, port_ref[0]):
        np.testing.assert_array_equal(a, b)
    # (hit rates may differ: at depth 2 a batch probes before its
    # predecessor's retire applies the next cache plan)
    assert summary["requests"] == port_ref[2]["requests"]


def test_launch_serve_retires_every_request_on_cpu():
    args = launch_serve.parse_args(
        ["--device", "cpu", "--requests", "120", "--scale", "0.02"])
    out = launch_serve.run(args)
    assert out["requests"] == out["submitted"] == 120
    assert out["device"] == "cpu" and out["batches"] > 0
    assert out["nonfinite_scores"] == 0
