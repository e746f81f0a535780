"""The port's chaos harness, live reshard and migration against the JAX
package's, on the CPU.

Both packages get the same numpy seeds; the DLRM's weights come from the
reference's ``jax.random`` init and cross over with ``params_from_numpy``.
  * bit-equal against the reference: ``FaultSpec`` refusals,
    ``FaultSchedule.generate``, ``DegradedShard``, ``plan_schedule``'s
    timeline and WR cuts, ``rebalance_ranges``, ``plan_reshard`` /
    ``apply_reshard`` / ``permutation``, ``reshard_tables``,
    ``ConnectionMigrator`` events, and under one fault of each kind the
    firing log, the deterministic part of ``chaos.summary()``, the virtual
    latencies and the SLO verdicts fed from them;
  * scores within 1e-5 of the reference's (rtol and atol, f32);
  * within the port, scores bit-equal to a fault-free run across pipeline
    depth {1, 2, 4} x dedup x pushdown, with and without the faults, and
    across a live reshard grow and shrink during traffic.

Every server here uses ``BATCH_WAIT_S`` as its batcher deadline and is
driven by ``_serving_drive.drive``, which never polls an empty queue; every
drive runs under ``time_limit`` so a wait on a pool thread fails the test
instead of hanging the suite.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.chaos as jchaos
import repro.core.lookup_engine as JLE
import repro.core.migration as JMIG
import repro.core.sharding as JSH
import repro.data.pipeline as JPIPE
import repro.obs.metrics as JMET
import repro.obs.slo as JSLO
import repro.rdma as JRDMA
import repro.rdma.verbs as JVERBS
import repro.runtime.elastic as JEL
import repro.runtime.serving as JSERV
from repro.core import adaptive_cache as JAC
from repro.launch import serve as jlaunch
from repro.models import recsys as JR
import repro_torch.chaos as tchaos
import repro_torch.core.lookup_engine as TLE
import repro_torch.core.migration as TMIG
import repro_torch.core.sharding as TSH
import repro_torch.data.pipeline as TPIPE
import repro_torch.obs.metrics as TMET
import repro_torch.obs.slo as TSLO
import repro_torch.rdma as TRDMA
import repro_torch.rdma.verbs as TVERBS
import repro_torch.runtime.elastic as TEL
import repro_torch.runtime.serving as TSERV
from repro_torch.core import adaptive_cache as TAC
from repro_torch.data import synthetic as syn
from repro_torch.launch import serve as tlaunch
from repro_torch.models import recsys as R
from _serving_drive import BATCH_WAIT_S, drive, time_limit

BUCKET = 8
N_REQ = 48  # six batches, as the reference's chaos tests
TABLES = (("big", 4000, 4), ("mid", 1000, 2), ("small", 64, 1))
CFG_KW = dict(name="chaos-t", arch="dlrm", embed_dim=16, n_dense=13,
              bottom_mlp=(64, 16), mlp=(64, 32))
MEM_KW = dict(fixed_bytes=1 << 20, bytes_per_sample=1 << 10, hbm_bytes=1 << 28)


def _pkg(name, chaos, sh, le, mig, el, verbs, rdma, serv, pipe, met, slo, ac,
         recsys, params, server_kw):
    return types.SimpleNamespace(
        name=name, chaos=chaos, sh=sh, le=le, mig=mig, el=el, verbs=verbs,
        rdma=rdma, serv=serv, pipe=pipe, met=met, slo=slo, ac=ac, R=recsys,
        params=params, server_kw=server_kw)


JAX = _pkg("jax", jchaos, JSH, JLE, JMIG, JEL, JVERBS, JRDMA, JSERV, JPIPE,
           JMET, JSLO, JAC, JR,
           lambda p: jax.tree_util.tree_map(jnp.asarray, p), {})
TORCH = _pkg("torch", tchaos, TSH, TLE, TMIG, TEL, TVERBS, TRDMA, TSERV, TPIPE,
             TMET, TSLO, TAC, R, lambda p: R.params_from_numpy(p, "cpu"),
             {"device": "cpu"})
PKGS = (JAX, TORCH)


def _scenario(pkg, reshard_to=8):
    """One fault of each kind, recoveries inside the six-batch run (the
    reference's ``_SCENARIO`` in tests/test_chaos.py)."""
    c = pkg.chaos
    return c.FaultSchedule(faults=(
        c.FaultSpec(c.FAULT_KILL_ENGINE, at_batch=2, target=1),
        c.FaultSpec(c.FAULT_DROP_SHARD, at_batch=3, target=0,
                    duration_batches=2),
        c.FaultSpec(c.FAULT_STRAGGLER_STORM, at_batch=4, target=1,
                    duration_batches=2, latency_mult=8.0),
        c.FaultSpec(c.FAULT_RESHARD, at_batch=5, target=reshard_to),
    ), seed=0)


def _strip_wall(summary):
    return {k: v for k, v in summary.items() if k != "wall"}


@pytest.fixture(scope="module")
def world():
    cfgs = {
        pkg.name: pkg.R.RecsysConfig(
            tables=tuple(pkg.sh.TableSpec(n, v, nnz=k) for n, v, k in TABLES),
            **CFG_KW)
        for pkg in PKGS
    }
    np_params = jax.tree_util.tree_map(
        np.asarray, JR.init_params(cfgs["jax"], jax.random.key(0)))
    rng = np.random.default_rng(3)
    reqs = []
    for _ in range(N_REQ):
        b = syn.recsys_batch(rng, cfgs["torch"].tables, 1,
                             n_dense=cfgs["torch"].n_dense)
        reqs.append({"indices": b["indices"][0], "mask": b["mask"][0],
                     "dense": b["dense"][0]})
    return cfgs, np_params, reqs


def _server(pkg, world, depth=2, dedup=True, pushdown=True, chaos=None,
            registry=None, engine="pooled", hedge_timeout=0.05):
    cfgs, np_params, _ = world
    cfg = cfgs[pkg.name]
    return pkg.serv.FlexEMRServer(
        cfg, pkg.params(np_params),
        pkg.sh.make_fused_tables(cfg.tables, cfg.embed_dim, 4),
        controller=pkg.ac.AdaptiveCacheController(
            cfg.tables, cfg.embed_dim, pkg.ac.MemoryModel(**MEM_KW),
            field_replication=False, max_rows=1024),
        cache_refresh_every=3, pipeline_depth=depth,
        hedge_timeout=hedge_timeout, dedup=dedup, pushdown=pushdown,
        batcher=pkg.pipe.BucketBatcher(buckets=(BUCKET,),
                                       max_wait=BATCH_WAIT_S),
        chaos=chaos, registry=registry or pkg.met.MetricsRegistry(),
        engine=engine, **pkg.server_kw,
    )


def _drive(server, reqs, after_retire=None):
    """Submit ``reqs`` and drive them in full buckets; returns the retired
    scores, the pool's virtual latencies and its summary."""
    with time_limit():
        try:
            for r in reqs:
                server.submit(r)
            outs = drive(server, len(reqs) // BUCKET, after_retire)
            vlat = list(server.service.virtual_latencies)
            engine = server.engine_summary()
        finally:
            server.close()
    return outs, vlat, engine


def _run(pkg, world, depth=2, dedup=True, pushdown=True, faults=False,
         **kw):
    injector = (pkg.chaos.ChaosInjector(_scenario(pkg), watchdog_s=10.0)
                if faults else None)
    outs, vlat, engine = _drive(
        _server(pkg, world, depth, dedup, pushdown, chaos=injector, **kw),
        world[2])
    return outs, vlat, engine, injector


@pytest.fixture(scope="module")
def port_ref(world):
    """The port's fault-free run at depth 1, dedup and pushdown on."""
    return _run(TORCH, world, depth=1)[0]


@pytest.fixture(scope="module")
def chaos_pair(world):
    """Both packages under the scenario at depth 2, dedup on."""
    return {pkg.name: _run(pkg, world, faults=True) for pkg in PKGS}


# ----------------------------------------------------------- fault taxonomy


@pytest.mark.parametrize("kind, kw, match", [
    ("power_cut", dict(at_batch=1), "unknown fault kind"),
    ("kill_engine", dict(), "exactly one"),
    ("kill_engine", dict(at_batch=1, at_vtime=0.5), "exactly one"),
    ("straggler_storm", dict(at_batch=1, latency_mult=0.5), "latency_mult"),
], ids=["unknown-kind", "no-trigger", "two-triggers", "speedup-mult"])
def test_fault_spec_refusals_match_reference(kind, kw, match):
    errs = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match=match) as e:
            pkg.chaos.FaultSpec(kind, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("seed, num_batches, n_faults", [
    (0, 32, 4), (7, 32, 4), (11, 6, 4), (3, 64, 8), (5, 4, 2), (0, 31, 4),
])
def test_fault_schedule_generate_matches_reference(seed, num_batches,
                                                   n_faults):
    kw = dict(num_batches=num_batches, num_engines=4, num_shards=8,
              n_faults=n_faults)
    a = JAX.chaos.FaultSchedule.generate(seed, **kw)
    b = TORCH.chaos.FaultSchedule.generate(seed, **kw)
    assert b.seed == a.seed and len(b.faults) == len(a.faults) == n_faults
    assert [f.__dict__ for f in b.faults] == [f.__dict__ for f in a.faults]


def test_fault_schedule_generate_rejects_tiny_run():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="num_batches"):
            pkg.chaos.FaultSchedule.generate(0, num_batches=1,
                                             num_engines=4, num_shards=4)


def _shards(rows=32, dim=8, seed=0):
    data = np.random.default_rng(seed).normal(size=(rows, dim)).astype(
        np.float32)
    return [pkg.le.EmbeddingServer(0, 0, data) for pkg in PKGS], data


def test_degraded_shard_matches_reference():
    """Replica rows serve bit-equal to the real shard and to the reference's
    stand-in; a cold row fails fast with the port's ShardUnavailableError;
    after restore everything forwards."""
    reals, data = _shards()
    hot = np.array([3, 7, 11], np.int64)
    degs = [pkg.chaos.DegradedShard(real, hot, data[hot].copy())
            for pkg, real in zip(PKGS, reals)]
    bag = np.array([0, 0, 1], np.int64)
    for fn in (lambda d: d.lookup_rows(hot),
               lambda d: d.lookup_pooled(hot, bag, 2)):
        np.testing.assert_array_equal(fn(degs[1]), fn(degs[0]))
        np.testing.assert_array_equal(fn(degs[1]), fn(reals[1]))
    with pytest.raises(TORCH.le.ShardUnavailableError, match="row 4"):
        degs[1].lookup_rows(np.array([3, 4], np.int64))
    with pytest.raises(TORCH.le.ShardUnavailableError):
        degs[1].read_range(0, 2)
    assert (degs[1].served_rows, degs[1].refused) == (12, 2)  # 2 calls x 6
    degs[1].restore()
    np.testing.assert_array_equal(degs[1].read_range(2, 3), data[2:5])


# ------------------------------------------------- engine pool fault surface


def _pool(pkg, num_shards=4, dim=16, num_threads=4):
    specs = (pkg.sh.TableSpec("a", 500, nnz=4),
             pkg.sh.TableSpec("b", 300, nnz=2, pooling="mean"),
             pkg.sh.TableSpec("c", 40, nnz=1))
    tables = pkg.sh.make_fused_tables(specs, dim, num_shards)
    rng = np.random.default_rng(7)
    tnp = (0.05 * rng.normal(size=(tables.total_rows, dim))).astype(
        np.float32)
    return tables, tnp, pkg.rdma.PooledLookupService(
        tables, tnp, num_threads=num_threads)


def test_pool_faults_match_reference():
    """Kill a thread, then price a straggler storm: the port's outputs and
    virtual spans equal the reference's, batch by batch."""
    res = {}
    for pkg in PKGS:
        tables, _, svc = _pool(pkg, num_threads=3)
        rng = np.random.default_rng(1)
        batches = [syn.recsys_batch(rng, tables.specs, 16) for _ in range(2)]
        batches = batches + batches  # the storm serves batch 0 again
        outs, spans = [], []
        with time_limit():
            try:
                for i, b in enumerate(batches):
                    if i == 1:
                        svc.pool.kill_thread(1)
                    if i == 2:
                        svc.pool.latency_mults[0] = 8.0
                    if i == 3:
                        svc.pool.latency_mults.clear()
                    outs.append(svc.lookup(b["indices"], b["mask"]))
                    spans.append(svc.pool.virtual_span)
                summary = svc.engine_summary()
            finally:
                svc.close()
        res[pkg.name] = outs, spans, summary
    (jo, js, jsum), (to, ts, tsum) = res["jax"], res["torch"]
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(to[0], to[2])  # slower, never different
    assert ts == js and ts[2] - ts[1] > ts[1] - ts[0]
    assert tsum["killed_threads"] == jsum["killed_threads"] == 1


def test_drop_shard_parks_until_restore():
    tables, tnp, svc = _pool(TORCH)
    with time_limit():
        try:
            b = syn.recsys_batch(np.random.default_rng(2), tables.specs, 16)
            ref = svc.lookup(b["indices"], b["mask"])
            deg = TORCH.chaos.DegradedShard(
                svc.pool.servers[0], np.zeros(0, np.int64),
                np.zeros((0, tnp.shape[1]), np.float32))
            svc.pool.mark_shard_dropped(0, deg)
            h = svc.lookup_async(b["indices"], b["mask"], hedge_timeout=None)
            with pytest.raises(TimeoutError):
                h.wait(0.3)  # parked on the dropped shard, not failed
            assert svc.pool.parked_count() > 0
            released = svc.pool.restore_shard(0)
            np.testing.assert_array_equal(h.wait(5.0), ref)
            s = svc.engine_summary()
            assert s["wrs_parked"] == s["parked_released"] == released > 0
        finally:
            svc.close()
    assert all(not t.is_alive() for t in svc.pool.threads)


def test_pool_reshard_refused_while_shard_dropped():
    for pkg in PKGS:
        _, tnp, svc = _pool(pkg)
        try:
            deg = pkg.chaos.DegradedShard(
                svc.pool.servers[0], np.zeros(0, np.int64),
                np.zeros((0, tnp.shape[1]), np.float32))
            svc.pool.mark_shard_dropped(0, deg)
            with pytest.raises(RuntimeError, match="restore first"):
                svc.pool.set_servers(list(svc.pool.servers))
            svc.pool.restore_shard(0)
            svc.pool.set_servers(list(svc.pool.servers))
        finally:
            svc.close()


def _wrs(pkg, n, servers=3, rbytes=2048, mult_every=0):
    return [
        pkg.verbs.LookupSubrequest(
            server=i % servers, row_ids=np.arange(4) + 4 * i,
            bag_ids=np.zeros(4, np.int64), num_bags=8, pushdown=True,
            response_bytes=rbytes + 64 * i, slot=i, request_bytes=16 * i,
            latency_mult=8.0 if mult_every and i % mult_every == 0 else 1.0,
        )
        for i in range(n)
    ]


@pytest.mark.parametrize("n, engines, kw, mult_every", [
    (17, 4, dict(doorbell_batch=4, max_inflight=8), 0),
    (24, 1, dict(), 0),
    (40, 3, dict(doorbell_batch=2, max_inflight=4), 3),
    (33, 4, dict(work_stealing=False), 5),
    (20, 4, dict(disabled={1}), 2),
    (16, 2, dict(affinity=np.array([1, 1, 0])), 0),
], ids=["doorbell", "one-engine", "storm", "no-steal", "killed", "affinity"])
def test_plan_schedule_matches_reference(n, engines, kw, mult_every):
    """The verbs layer's virtual timeline and WR cuts, two batches through
    one carried state: engine assignment, completion times, busy, steals,
    doorbells, makespan and credit stalls are bit-equal."""
    plans = {}
    for pkg in PKGS:
        timing = pkg.verbs.VerbsTiming()
        state = pkg.verbs.VerbsState.fresh(engines)
        out = []
        for b in range(2):
            wrs = _wrs(pkg, n, mult_every=mult_every)
            p = pkg.verbs.plan_schedule(wrs, engines, timing, state=state,
                                        batch_id=b, **kw)
            out.append((
                [[(r.slot, r.engine, r.stolen, r.v_complete) for r in lane]
                 for lane in p.assignments],
                p.makespan, p.busy, p.steals, p.doorbells, p.arrival, p.end,
                p.credit_stall,
            ))
            state.sync(p.end)
        plans[pkg.name] = out
    assert plans["torch"] == plans["jax"]


# ------------------------------------------------- reshard plans + elasticity


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_ranges_matches_reference(seed):
    load = np.random.default_rng(seed).random(8) * 10 + 0.1
    if seed == 5:
        load[3] = 64.0  # one hot shard
    got = []
    for pkg in PKGS:
        specs = (pkg.sh.TableSpec("a", 500, nnz=4),
                 pkg.sh.TableSpec("b", 300, nnz=2, pooling="mean"),
                 pkg.sh.TableSpec("c", 40, nnz=1))
        got.append(pkg.sh.rebalance_ranges(
            load, pkg.sh.make_fused_tables(specs, 8, 8)))
    assert got[1].dtype == got[0].dtype
    np.testing.assert_array_equal(got[1], got[0])


def _plan_tables(pkg, num_shards=4, rows_per_shard=8):
    return pkg.sh.make_fused_tables(
        (pkg.sh.TableSpec("t", num_shards * rows_per_shard, nnz=1),), 4,
        num_shards)


@pytest.mark.parametrize("hot_shard, hot_load", [
    (0, 8.0), (3, 2.5), (7, 64.0), (5, 17.25),
])
def test_plan_and_apply_reshard_match_reference(hot_shard, hot_load):
    load = np.ones(8)
    load[hot_shard] = hot_load
    table = np.random.default_rng(hot_shard).normal(
        size=(128, 4)).astype(np.float32)
    got = []
    for pkg in PKGS:
        tables = _plan_tables(pkg, num_shards=8, rows_per_shard=16)
        plan = pkg.mig.plan_reshard(load, tables)
        got.append((plan, pkg.mig.permutation(plan, tables),
                    pkg.mig.apply_reshard(table, plan, tables)))
    (jp, jperm, jt), (tp, tperm, tt) = got
    np.testing.assert_array_equal(tp.boundaries, jp.boundaries)
    assert (tp.expected_imbalance_before, tp.expected_imbalance_after) == \
        (jp.expected_imbalance_before, jp.expected_imbalance_after)
    assert tp.expected_imbalance_after <= tp.expected_imbalance_before
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("boundaries, rows, match", [
    ([0, "n"], None, "ranges for 4 shards"),
    ([0, 8, 16, 24, "n-1"], None, "covers"),
    ([1, 8, 16, 24, "n"], None, "covers"),
    ([0, 16, 8, 24, "n"], None, "non-decreasing"),
    ([0, 8, 16, 24, "n"], "n-1", "rows"),
], ids=["count", "short-cover", "late-start", "decreasing", "table-length"])
def test_reshard_plan_refusals_match_reference(boundaries, rows, match):
    errs = []
    for pkg in PKGS:
        tables = _plan_tables(pkg)
        n = tables.total_rows
        b = [{"n": n, "n-1": n - 1}.get(x, x) for x in boundaries]
        plan = pkg.mig.ReshardPlan(np.array(b), 1.0, 1.0)
        with pytest.raises(ValueError, match=match) as e:
            if rows is None:
                pkg.mig.permutation(plan, tables)
            else:
                pkg.mig.apply_reshard(np.zeros((n - 1, 4), np.float32),
                                      plan, tables)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("vocab, n_shards, m_shards", [
    (5, 1, 8), (600, 8, 3), (97, 4, 8), (333, 3, 3), (250, 8, 12), (64, 2, 1),
])
def test_reshard_tables_matches_reference(vocab, n_shards, m_shards):
    """moved_rows and the re-split table are bit-equal, and N -> M -> N
    returns every raw row."""
    got = []
    for pkg in PKGS:
        tables = pkg.sh.make_fused_tables(
            (pkg.sh.TableSpec("t", vocab, nnz=1),), 4, n_shards)
        table = np.random.default_rng(vocab).normal(
            size=(tables.total_rows, 4)).astype(np.float32)
        mid = pkg.el.reshard_tables(tables, table, m_shards)
        back = pkg.el.reshard_tables(mid.tables, mid.table, n_shards)
        got.append((mid, back, tables, table))
    (jm, jb, _, _), (tm, tb, tables, table) = got
    assert tm.moved_rows == jm.moved_rows
    assert (tm.tables.num_shards, tm.tables.total_rows) == \
        (jm.tables.num_shards, jm.tables.total_rows)
    np.testing.assert_array_equal(tm.table, jm.table)
    np.testing.assert_array_equal(tb.table[:tables.raw_rows],
                                  table[:tables.raw_rows])
    assert tb.moved_rows == jb.moved_rows
    if n_shards == m_shards:
        assert tm.moved_rows == 0


def test_reshard_params_keeps_torch_tensors():
    """The port's params hold torch tensors: reshard_params returns the
    re-split table as a tensor of the same dtype and device, and its rows
    equal the reference's numpy result."""
    tables = TSH.make_fused_tables((TSH.TableSpec("t", 97, nnz=1),), 4, 4)
    table = np.random.default_rng(0).normal(
        size=(tables.total_rows, 4)).astype(np.float32)
    new_tables, new = TEL.reshard_params(
        tables, R.params_from_numpy({"table": table}, "cpu"), 8)
    jtables = JSH.make_fused_tables((JSH.TableSpec("t", 97, nnz=1),), 4, 4)
    jnew_tables, jnew = JEL.reshard_params(jtables, {"table": table}, 8)
    assert new_tables.total_rows == jnew_tables.total_rows
    assert new["table"].device.type == "cpu"
    np.testing.assert_array_equal(new["table"].numpy(),
                                  np.asarray(jnew["table"]))


def test_connection_migrator_events_match_reference():
    """One hammered lookup on the legacy per-connection engines, then one
    monitoring tick: the same connection moves between the same engines,
    and the service still answers as before."""
    got = []
    for pkg in PKGS:
        specs = (pkg.sh.TableSpec("a", 500, nnz=4),
                 pkg.sh.TableSpec("b", 300, nnz=2, pooling="mean"),
                 pkg.sh.TableSpec("c", 40, nnz=1))
        tables = pkg.sh.make_fused_tables(specs, 16, 8)
        tnp = np.random.default_rng(4).normal(
            size=(tables.total_rows, 16)).astype(np.float32)
        svc = pkg.le.HostLookupService(tables, tnp, num_engines=2)
        b = syn.recsys_batch(np.random.default_rng(6), tables.specs, 64)
        with time_limit():
            try:
                mig = pkg.mig.ConnectionMigrator(svc, imbalance_threshold=0.5)
                before = svc.lookup(b["indices"], b["mask"])
                events = [mig.rebalance_once() for _ in range(3)]
                after = svc.lookup(b["indices"], b["mask"])
            finally:
                svc.close()
        got.append((before, after,
                    [[e.__dict__ for e in tick] for tick in events]))
    (jb, ja, je), (tb, ta, te) = got
    assert te == je and any(te)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ta, tb)


# ----------------------------------------------- serving-level chaos matrix


def test_chaos_run_matches_reference(chaos_pair):
    """Kill + drop + storm + reshard 4 -> 8 under traffic in both packages:
    the same firing log and deterministic summary, the same virtual
    latencies, and scores within 1e-5 of the reference's."""
    jo, jv, je, jinj = chaos_pair["jax"]
    to, tv, te, tinj = chaos_pair["torch"]
    js, ts = jinj.summary(), tinj.summary()
    assert ts["firing_log"] == js["firing_log"]
    assert [k for (_, k, _) in ts["firing_log"]] == list(TORCH.chaos.FAULT_KINDS)
    assert _strip_wall(ts) == _strip_wall(js)
    assert ts["moved_rows"] > 0 and ts["restores"] == 1
    assert tv == jv
    assert te["killed_threads"] == je["killed_threads"] == 1
    assert len(to) == len(jo) == N_REQ // BUCKET
    for a, b in zip(jo, to):
        assert b.dtype == np.float32 and np.all(np.isfinite(b))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_chaos_slo_verdicts_match_reference(chaos_pair):
    """SLO monitors fed the chaos run's virtual latencies on an explicit
    clock reach the same verdicts in both packages."""
    summaries = []
    vlat = chaos_pair["torch"][1]
    for pkg, (_, vl, _, _) in zip(PKGS, (chaos_pair["jax"], chaos_pair["torch"])):
        mon = pkg.slo.SloMonitor(pkg.slo.SloObjective(
            latency_target_s=float(np.median(vlat)), target=0.5,
            min_samples=2))
        now = 0.0
        for lat in vl:
            now += lat
            mon.observe(lat, now=now)
        summaries.append(mon.summary(now=now))
    assert summaries[1] == summaries[0]
    assert 0 < summaries[1]["good_fraction"] < 1


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "chaos"])
@pytest.mark.parametrize("pushdown", [True, False], ids=["push", "nopush"])
@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "nodedup"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_port_scores_bit_equal_across_grid(world, port_ref, depth, dedup,
                                           pushdown, faults):
    """The invariance grid: pipeline depth x dedup x pushdown, with and
    without one fault of each kind, leaves every retired score bit-equal to
    the fault-free depth-1 run."""
    outs, _, engine, injector = _run(TORCH, world, depth, dedup, pushdown,
                                     faults)
    if faults:
        s = injector.summary()
        assert s["faults_fired"] == 4 and s["faults_skipped"] == 0
        assert s["by_kind"] == {k: 1 for k in TORCH.chaos.FAULT_KINDS}
        assert s["restores"] == 1 and s["active_drops"] == []
        assert s["wall"]["forced_restores"] == 0
        assert engine["killed_threads"] == 1 and engine["parked_now"] == 0
    assert len(outs) == len(port_ref)
    for i, (a, b) in enumerate(zip(outs, port_ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i} diverged")


def test_port_chaos_same_seed_same_firing(world, chaos_pair):
    """A second run of the same schedule fires the same faults at the same
    batches and gives the same scores and virtual latencies."""
    outs_a, vlat_a, _, inj_a = chaos_pair["torch"]
    outs_b, vlat_b, _, inj_b = _run(TORCH, world, faults=True)
    assert inj_b.summary()["firing_log"] == inj_a.summary()["firing_log"]
    assert _strip_wall(inj_b.summary()) == _strip_wall(inj_a.summary())
    assert vlat_b == vlat_a
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_array_equal(a, b)


def test_live_reshard_grow_shrink_under_traffic(world, port_ref):
    """FlexEMRServer.reshard mid-stream (4 -> 8 -> 2) keeps scores bit-equal,
    and each step moves the rows reshard_tables counts on the host and the
    reference's server reports."""
    cut = {2: 8, 4: 2}  # retire count -> new shard total
    results = {}
    for pkg in PKGS:
        res = []

        def reshard(server, n_retired):
            if n_retired in cut:
                before = (server.tables, server.table_np)
                r = server.reshard(cut[n_retired])
                want = pkg.el.reshard_tables(*before, cut[n_retired])
                assert r["moved_rows"] == want.moved_rows > 0
                np.testing.assert_array_equal(server.table_np, want.table)
                res.append(r)

        server = _server(pkg, world, depth=2)
        outs, _, _ = _drive(server, world[2], after_retire=reshard)
        assert server.tables.num_shards == 2
        assert len(server.service.pool.servers) == 2
        results[pkg.name] = outs, res
    assert [r["num_shards"] for r in results["torch"][1]] == [8, 2]
    assert [r["moved_rows"] for r in results["torch"][1]] == \
        [r["moved_rows"] for r in results["jax"][1]]
    for a, b in zip(results["torch"][0], port_ref):
        np.testing.assert_array_equal(a, b)


def test_watchdog_force_restores_indefinite_drop(world, port_ref):
    """An outage with no scheduled recovery: the guarded wait's watchdog
    force-restores it, and the scores still match the fault-free run."""
    c = TORCH.chaos
    injector = c.ChaosInjector(c.FaultSchedule(faults=(
        c.FaultSpec(c.FAULT_DROP_SHARD, at_batch=2, target=0),
    ), seed=0), watchdog_s=0.4, wait_step_s=0.1)
    outs, _, engine = _drive(_server(TORCH, world, chaos=injector), world[2])
    s = injector.summary()
    assert s["wall"]["forced_restores"] >= 1
    assert s["restores"] == 1 and s["active_drops"] == []
    assert engine["parked_now"] == 0
    for a, b in zip(outs, port_ref):
        np.testing.assert_array_equal(a, b)


def test_close_drains_with_fault_pending(world):
    """close() with a shard still down and the pipeline full: drain()
    restores it first, every admitted batch completes, no thread is left."""
    c = TORCH.chaos
    injector = c.ChaosInjector(c.FaultSchedule(faults=(
        c.FaultSpec(c.FAULT_DROP_SHARD, at_batch=1, target=0),
    ), seed=0), watchdog_s=10.0)
    server = _server(TORCH, world, depth=4, chaos=injector,
                     hedge_timeout=None)
    with time_limit():
        try:
            for r in world[2][:32]:
                server.submit(r)
            for _ in range(4):
                assert server._admit_next()
            assert injector.summary()["active_drops"] == [0]
        finally:
            server.close()
    assert not server._pipeline
    assert injector.summary()["active_drops"] == []
    assert server.service.pool.parked_count() == 0
    assert all(not t.is_alive() for t in server.service.pool.threads)


def test_chaos_registers_metrics_namespace(world):
    registry = TORCH.met.MetricsRegistry()
    injector = TORCH.chaos.ChaosInjector(_scenario(TORCH), watchdog_s=10.0)
    _drive(_server(TORCH, world, chaos=injector, registry=registry),
           world[2])
    snap = registry.snapshot()
    assert snap["chaos.faults_fired"] == 4 and snap["chaos.restores"] == 1
    assert any(k.startswith("serve.") for k in snap)


# ------------------------------------------------------------------ refusals


def test_chaos_refused_on_legacy_engine(world):
    for pkg in PKGS:
        with pytest.raises(ValueError, match="pooled"):
            _server(pkg, world, engine="legacy", hedge_timeout=None,
                    chaos=pkg.chaos.ChaosInjector(_scenario(pkg)))


def test_server_reshard_refusals_match_reference(world):
    """reshard(0) is a ValueError, and a reshard while a shard is dropped a
    RuntimeError, in both packages; the server still serves afterwards."""
    for pkg in PKGS:
        server = _server(pkg, world, hedge_timeout=None)
        with time_limit():
            try:
                with pytest.raises(ValueError):
                    server.reshard(0)
                pool = server.service.pool
                pool.mark_shard_dropped(0, pkg.chaos.DegradedShard(
                    pool.servers[0], np.zeros(0, np.int64),
                    np.zeros((0, CFG_KW["embed_dim"]), np.float32)))
                with pytest.raises(RuntimeError, match="restore first"):
                    server.reshard(8)
                pool.restore_shard(0)
                assert server.tables.num_shards == 4
                assert server.reshard(8)["num_shards"] == 8
            finally:
                server.close()


# ------------------------------------------------------------- launch.serve


@pytest.mark.parametrize("argv", [[], ["--chaos-faults", "6"]],
                         ids=["default", "six-faults"])
def test_build_chaos_matches_reference(argv):
    """The port's --chaos-seed / --chaos-faults / --reshard-to arm the same
    schedule as the reference's _build_chaos given the same arguments."""
    args = tlaunch.parse_args(["--device", "cpu", "--requests", "160",
                               "--scale", "0.02", "--chaos-seed", "0",
                               "--reshard-to", "12"] + argv)
    scheds = []
    for mod, pkg in ((jlaunch, JAX), (tlaunch, TORCH)):
        cfg = mod.make_serving_dlrm(args.scale)
        tables = pkg.sh.make_fused_tables(cfg.tables, cfg.embed_dim,
                                          args.num_servers)
        scheds.append(mod._build_chaos(args, tables, None).schedule)
    assert scheds[1].seed == scheds[0].seed
    assert [f.__dict__ for f in scheds[1].faults] == \
        [f.__dict__ for f in scheds[0].faults]
    assert ("reshard", 12) in [(f.kind, f.target) for f in scheds[1].faults]


def test_launch_serve_chaos_and_reshard_on_cpu():
    args = tlaunch.parse_args(["--device", "cpu", "--requests", "160",
                               "--scale", "0.02", "--chaos-seed", "0",
                               "--reshard-to", "12"])
    with time_limit():
        out = tlaunch.run(args)
    assert out["requests"] == out["submitted"] == 160
    assert out["nonfinite_scores"] == 0
    chaos = out["chaos"]
    assert chaos["reshards"] >= 1 and chaos["moved_rows"] > 0
    assert ("reshard", 12) in [(k, t) for (_, k, t) in chaos["firing_log"]]
    assert chaos["active_drops"] == []
