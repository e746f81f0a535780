"""The port's open-loop load harness against the JAX package's, on the CPU.

  * bit-equal against the reference: QPS schedules (breakpoints, rates,
    integrals) and their refusals, Poisson arrival times, generated events
    (times, deadlines, payloads, flash-crowd redirects), the virtual-clock
    ``replay_open_loop`` and the SLO verdicts it feeds;
  * arrival-stamped requests through both servers: scores within 1e-5 of
    the reference's (rtol and atol, f32), and within the port bit-equal
    across pipeline depth {1, 2, 4}, with exact latency attribution;
  * an arrival stamp in the future clamps to now in both packages;
  * the port's wall-clock ``OpenLoopDriver`` and ``launch.serve --arrival
    poisson|trace`` retire every request with finite scores.

Servers use ``BATCH_WAIT_S`` as their batcher deadline and are driven so
that no poll waits on an empty queue; each drive runs under
``time_limit``.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.loadgen as JL
from repro.core.sharding import TableSpec as JaxTableSpec
from repro.core.sharding import make_fused_tables as jax_fused_tables
from repro.data.pipeline import BucketBatcher as JaxBatcher
from repro.models import recsys as JR
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import SloMonitor as JaxSloMonitor
from repro.obs import SloObjective as JaxSloObjective
from repro.runtime.serving import FlexEMRServer as JaxServer
import repro_torch.loadgen as TL
from repro_torch.core.sharding import TableSpec, make_fused_tables
from repro_torch.data.pipeline import BucketBatcher
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recsys as R
from repro_torch.obs import MetricsRegistry, SloMonitor, SloObjective
from repro_torch.runtime.serving import FlexEMRServer
from _serving_drive import BATCH_WAIT_S, drive, time_limit

BUCKET = 8
TABLES = (("big", 4000, 4), ("mid", 1000, 2), ("small", 64, 1))
CFG_KW = dict(name="t", arch="dlrm", embed_dim=16, n_dense=13,
              bottom_mlp=(64, 16), mlp=(64, 32))


def _cfgs():
    jcfg = JR.RecsysConfig(
        tables=tuple(JaxTableSpec(n, v, nnz=k) for n, v, k in TABLES), **CFG_KW)
    tcfg = R.RecsysConfig(
        tables=tuple(TableSpec(n, v, nnz=k) for n, v, k in TABLES), **CFG_KW)
    return jcfg, tcfg


# ---------------------------------------------------------------- schedules


SCHEDULES = {
    "constant": lambda L: L.constant(2000.0, 1.5),
    "trace": lambda L: L.trace([(0.0, 100.0), (1.0, 300.0), (3.0, 300.0)]),
    "diurnal": lambda L: L.diurnal(500.0, 4000.0, duration=2.0),
    "diurnal-2c": lambda L: L.diurnal(100.0, 500.0, duration=2.0, cycles=2.0,
                                      steps=64),
    "flash": lambda L: L.flash_crowd(500.0, 5000.0, 1.0, 0.4, 0.7, field=1,
                                     hot_ids=(1, 2, 3), hot_frac=1.0)[0],
    "flash-at-0": lambda L: L.flash_crowd(200.0, 900.0, 0.5, 0.0, 0.1)[0],
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_reference(name):
    j, t = SCHEDULES[name](JL), SCHEDULES[name](TL)
    assert t.points == j.points
    assert (t.duration, t.peak, t.expected_arrivals()) == \
        (j.duration, j.peak, j.expected_arrivals())
    grid = np.linspace(-0.1, j.duration + 0.1, 97)
    assert [t.qps_at(x) for x in grid] == [j.qps_at(x) for x in grid]
    assert t.scaled(2.5).points == j.scaled(2.5).points


@pytest.mark.parametrize("make", [
    lambda L: L.QpsSchedule([(0.0, 1.0)]),
    lambda L: L.QpsSchedule([(1.0, 1.0), (0.0, 1.0)]),
    lambda L: L.QpsSchedule([(0.0, -1.0), (1.0, 1.0)]),
    lambda L: L.diurnal(100.0, 50.0, 1.0),
    lambda L: L.flash_crowd(10.0, 100.0, 1.0, spike_t0=0.8, spike_t1=1.5),
], ids=["one-point", "unsorted", "negative", "peak-below-base",
        "spike-outside"])
def test_schedule_refusals_match_reference(make):
    errs = []
    for L in (JL, TL):
        with pytest.raises(ValueError) as e:
            make(L)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ----------------------------------------------------- arrival determinism


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("seed", [0, 42])
def test_poisson_arrivals_match_reference(name, seed):
    j = JL.poisson_arrivals(SCHEDULES[name](JL), seed)
    t = TL.poisson_arrivals(SCHEDULES[name](TL), seed)
    assert t.dtype == np.float64 and len(t) > 0
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        TL.poisson_arrivals(SCHEDULES[name](TL), seed, max_events=50), j[:50])


@pytest.mark.parametrize("kind", ["plain", "deadline", "flash"])
def test_generated_events_match_reference(kind):
    jcfg, tcfg = _cfgs()
    evs = []
    for L, cfg in ((JL, jcfg), (TL, tcfg)):
        sched, crowd = L.constant(3000.0, 0.2), None
        if kind == "flash":
            sched, crowd = L.flash_crowd(
                base_qps=500.0, spike_qps=5000.0, duration=1.0, spike_t0=0.4,
                spike_t1=0.7, field=1, hot_ids=(1, 2, 3), hot_frac=0.75)
        evs.append(L.OpenLoopGenerator(
            sched, L.RecsysPayloadFactory(cfg.tables, cfg.n_dense,
                                          crowd=crowd),
            seed=9, deadline_s=0.05 if kind == "deadline" else None,
            max_events=256,
        ).events())
    assert len(evs[1]) == len(evs[0]) > 0
    for a, b in zip(*evs):
        assert (b.t, b.deadline_s) == (a.t, a.deadline_s)
        for k in ("indices", "mask", "dense"):
            assert b.payload[k].dtype == a.payload[k].dtype
            np.testing.assert_array_equal(b.payload[k], a.payload[k])
    if kind == "flash":
        hot = [e for e in evs[1] if 0.4 <= e.t < 0.7]
        assert hot and sum(set(e.payload["indices"][1].tolist()) <= {1, 2, 3}
                           for e in hot) > len(hot) // 2


# ------------------------------------------------- virtual-clock replay


def _slo(mon, obj, latency_target_s=0.05):
    return mon(obj(latency_target_s=latency_target_s, target=0.99,
                   fast_window_s=0.25, slow_window_s=1.0, burn_threshold=10.0,
                   min_samples=20), clock_epoch=0.0)


@pytest.mark.parametrize("qps, depth", [
    (3000.0, 1), (3000.0, 2), (3000.0, 4), (40000.0, 1), (40000.0, 2),
])
def test_replay_open_loop_and_slo_match_reference(qps, depth):
    """The replay's latencies, retire times and SLO verdicts are bit-equal
    to the reference's; at 40k req/s the queue grows and the SLO alert
    fires in both."""
    outs = []
    for L, mon, obj in ((JL, JaxSloMonitor, JaxSloObjective),
                        (TL, SloMonitor, SloObjective)):
        slo = _slo(mon, obj)
        times = L.poisson_arrivals(L.constant(qps, 1.0), seed=3)
        r = L.replay_open_loop(times, batch_size=32, lookup_s=0.002,
                               dense_s=0.0005, pipeline_depth=depth,
                               slo=slo, deadline_s=0.05)
        outs.append((r, slo.summary(now=r["retire_times"][-1])))
    (jr, js), (tr, ts) = outs
    for k in ("latencies", "retire_times"):
        np.testing.assert_array_equal(tr[k], jr[k])
    for k in ("batches", "makespan_s", "p50_s", "p99_s"):
        assert tr[k] == jr[k]
    assert ts == js
    if qps > 30000.0:
        assert ts["alerts_fired"] >= 1 and ts["breaches"] > 0


def test_replay_open_loop_rejects_zero_depth():
    for L in (JL, TL):
        with pytest.raises(ValueError, match="pipeline_depth"):
            L.replay_open_loop(np.zeros(4), 8, 0.001, 0.001, pipeline_depth=0)


# ------------------------------------------------- real-server open loop


@pytest.fixture(scope="module")
def served():
    """24 arrival-stamped events through the reference's server (depth 2)
    and the port's at depths 1, 2 and 4."""
    jcfg, tcfg = _cfgs()
    np_params = jax.tree_util.tree_map(
        np.asarray, JR.init_params(jcfg, jax.random.key(0)))
    events = TL.OpenLoopGenerator(
        TL.constant(4000.0, 0.2), TL.RecsysPayloadFactory(tcfg.tables,
                                                          tcfg.n_dense),
        seed=21, max_events=24,
    ).events()
    jserver = JaxServer(
        jcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
        jax_fused_tables(jcfg.tables, jcfg.embed_dim, 4), pipeline_depth=2,
        batcher=JaxBatcher(buckets=(BUCKET,), max_wait=BATCH_WAIT_S),
        registry=JaxRegistry(),
    )
    ref = _serve_events(jserver, events)
    port = {}
    for depth in (1, 2, 4):
        registry = MetricsRegistry()
        slo = SloMonitor(SloObjective(latency_target_s=30.0))
        server = FlexEMRServer(
            tcfg, R.params_from_numpy(np_params, "cpu"),
            make_fused_tables(tcfg.tables, tcfg.embed_dim, 4),
            pipeline_depth=depth,
            batcher=BucketBatcher(buckets=(BUCKET,), max_wait=BATCH_WAIT_S),
            registry=registry, slo=slo, device="cpu",
        )
        port[depth] = _serve_events(server, events) + (registry, slo)
    return events, ref, port


def _serve_events(server, events, arrival=None):
    """Submit every event up front with its arrival stamp (``arrival(ev)``,
    by default its intended time), then drive them in full buckets."""
    with time_limit():
        try:
            epoch = time.perf_counter()
            for ev in events:
                server.submit(ev.payload, deadline_s=ev.deadline_s,
                              arrival=epoch + ev.t if arrival is None
                              else arrival(ev))
            outs = drive(server, len(events) // BUCKET)
        finally:
            server.close()
    return outs, server.metrics


def test_stamped_scores_match_reference(served):
    events, (j_outs, _), port = served
    t_outs, metrics = port[2][:2]
    assert metrics.requests == len(events)
    assert len(t_outs) == len(j_outs) == len(events) // BUCKET
    for a, b in zip(j_outs, t_outs):
        assert b.dtype == np.float32 and np.all(np.isfinite(b))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth", [2, 4])
def test_stamped_scores_bit_equal_across_depths(served, depth):
    outs, ref = served[2][depth][0], served[2][1][0]
    assert len(outs) == len(ref)
    for a, b in zip(outs, ref):
        np.testing.assert_array_equal(a, b)


def test_stamped_attribution_and_slo(served):
    events, _, port = served
    _, _, registry, slo = port[2]
    snap = registry.snapshot()
    # exact tiling: attributed time covers end-to-end latency exactly
    assert snap["serve.attr.coverage"] == pytest.approx(1.0, abs=1e-9)
    assert snap["serve.queue_wait.count"] == len(events)
    assert snap["serve.pipeline.occupancy"] == 0
    assert slo.requests == snap["slo.requests"] == len(events)
    assert snap["slo.good_fraction"] == 1.0  # 30 s target: all good
    assert slo.deadline_total == 0
    assert snap["serve.queue_wait.max"] > 0.0


def test_future_arrival_stamps_clamp_to_now():
    """An arrival stamp in the future clamps to the submit instant in both
    packages, so queue wait and latency never go negative."""
    jcfg, tcfg = _cfgs()
    np_params = jax.tree_util.tree_map(
        np.asarray, JR.init_params(jcfg, jax.random.key(0)))
    events = TL.OpenLoopGenerator(
        TL.constant(4000.0, 0.2), TL.RecsysPayloadFactory(tcfg.tables,
                                                          tcfg.n_dense),
        seed=21, max_events=16,
    ).events()
    servers = (
        JaxServer(jcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
                  jax_fused_tables(jcfg.tables, jcfg.embed_dim, 4),
                  pipeline_depth=2, registry=JaxRegistry(),
                  batcher=JaxBatcher(buckets=(BUCKET,),
                                     max_wait=BATCH_WAIT_S)),
        FlexEMRServer(tcfg, R.params_from_numpy(np_params, "cpu"),
                      make_fused_tables(tcfg.tables, tcfg.embed_dim, 4),
                      pipeline_depth=2, registry=MetricsRegistry(),
                      batcher=BucketBatcher(buckets=(BUCKET,),
                                            max_wait=BATCH_WAIT_S),
                      device="cpu"),
    )
    for server in servers:
        _serve_events(server, events,
                      arrival=lambda ev: time.perf_counter() + 1000.0)
        assert server.metrics.requests == len(events)
        assert server.metrics.queue_wait_hist.min >= 0.0
        assert server.metrics.latency_hist.min >= 0.0
        assert server.metrics.latency_hist.max < 1000.0


def test_open_loop_driver_retires_every_request():
    """The wall-clock driver against the port's server: every arrival is
    submitted once, retires once, and every retired batch reaches
    ``on_output`` with finite scores."""
    _, tcfg = _cfgs()
    events = TL.OpenLoopGenerator(
        TL.constant(400.0, 0.25), TL.RecsysPayloadFactory(tcfg.tables,
                                                         tcfg.n_dense),
        seed=5,
    ).events()
    server = FlexEMRServer(
        tcfg, R.init_params(tcfg, 0, device="cpu"),
        make_fused_tables(tcfg.tables, tcfg.embed_dim, 4), pipeline_depth=2,
        batcher=BucketBatcher(buckets=(8, 16, 32), max_wait=0.02),
        registry=MetricsRegistry(), device="cpu",
    )
    retired = []
    with time_limit():
        try:
            stats = TL.OpenLoopDriver().run(server, events,
                                            on_output=retired.append)
        finally:
            server.close()
    assert stats["submitted"] == len(events) > 50 and stats["shed"] == 0
    assert server.metrics.requests == len(events)
    assert len(retired) == server.metrics.batches
    assert sum(len(r["degraded"]) for r in retired) == len(events)
    assert all(np.isfinite(r["scores"]).all() for r in retired)
    assert stats["submit_lag_max_s"] >= stats["submit_lag_mean_s"] >= 0.0


def test_launch_serve_poisson_on_cpu():
    args = launch_serve.parse_args([
        "--device", "cpu", "--arrival", "poisson", "--qps", "200",
        "--duration", "0.5", "--scale", "0.02"])
    with time_limit():
        out = launch_serve.run(args)
    lg = out["loadgen"]
    assert lg["submitted"] == out["requests"] == out["submitted"] > 0
    assert lg["shed"] == 0 and out["nonfinite_scores"] == 0
    assert out["slo"]["requests"] == out["requests"]
    assert "chaos" not in out


def test_launch_serve_trace_on_cpu(tmp_path):
    path = tmp_path / "sched.json"
    path.write_text(json.dumps([[0.0, 100.0], [0.3, 300.0], [0.6, 100.0]]))
    args = launch_serve.parse_args([
        "--device", "cpu", "--arrival", "trace", "--qps-trace", str(path),
        "--scale", "0.02"])
    with time_limit():
        out = launch_serve.run(args)
    want = len(TL.poisson_arrivals(
        TL.trace([(0.0, 100.0), (0.3, 300.0), (0.6, 100.0)]), args.seed))
    assert out["requests"] == out["loadgen"]["submitted"] == want
    assert out["nonfinite_scores"] == 0


def test_launch_serve_trace_needs_a_schedule():
    args = launch_serve.parse_args(["--device", "cpu", "--arrival", "trace",
                                    "--scale", "0.02"])
    with pytest.raises(SystemExit, match="--qps-trace"):
        launch_serve.run(args)


def test_elastic_serve_example_on_cpu(monkeypatch, capsys):
    """examples/torch_elastic_serve.py: open-loop traffic, a reshard 8 -> 12
    partway through, the tier's sums bit-equal across the cutover."""
    import runpy
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / \
        "torch_elastic_serve.py"
    monkeypatch.setattr("sys.argv", [str(path), "--device", "cpu", "--scale",
                                     "0.02", "--qps", "200", "--duration",
                                     "0.5"])
    with time_limit():
        runpy.run_path(str(path), run_name="__main__")
    text = capsys.readouterr().out
    out = json.loads(text[:text.rindex("}") + 1])
    assert out["shards"] == [8, 12] and out["reshard"]["moved_rows"] > 0
    assert "bit-equal across the cutover" in text
