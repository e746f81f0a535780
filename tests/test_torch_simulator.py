"""The port's lookup simulator against the JAX package's, on the CPU.

``runtime/simulator.py`` is numpy only, so for the same seed and config
every output is bit-equal to the reference's: ``LookupSimulator.run`` and
each ``compare_*`` sweep at a cut batch count, and ``calibrate_to_engine``
on the same measured utilization.  Calibrated against the port's own
engine pool it lands within 0.1 of the pool's utilization, as the
reference's against its pool (tests/test_rdma.py).
"""
import math

import numpy as np
import pytest

import repro.runtime.simulator as JS
import repro_torch.runtime.simulator as TS
from repro_torch.core.sharding import TableSpec, make_fused_tables
from repro_torch.data import synthetic as syn
from repro_torch.rdma import PooledLookupService

N_BATCHES = 120  # the reference sweeps use 2000; the outputs are exact


def _assert_bit_equal(got, want, path="out"):
    """Recursive equality of nested dicts/lists of floats and arrays, NaN
    equal to NaN (the sweeps' overhead ratio is NaN when no 0 accuracy)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_bit_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mapping_aware=False),
    dict(migration=True, skew_alpha=1.2, n_units=8),
    dict(t_dense=30e-6, inflight=2),
    dict(cache_hit_rate=0.5, prefetch_accuracy=0.75,
         prefetch_budget_frac=0.25),
    dict(dup_frac=0.4, dedup_wire=True, poolable_frac=0.7,
         pushdown_wire=True, request_bytes_per_subrequest=512.0),
], ids=["aware", "naive", "migration", "dense", "prefetch", "wire"])
def test_lookup_simulator_run_matches_reference(kw):
    want = JS.LookupSimulator(JS.SimConfig(n_batches=N_BATCHES, seed=3,
                                           **kw)).run()
    got = TS.LookupSimulator(TS.SimConfig(n_batches=N_BATCHES, seed=3,
                                          **kw)).run()
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("name, kw", [
    ("compare_engines", {}),
    ("compare_hit_rates", {}),
    ("compare_prefetch", {}),
    ("compare_dedup", dict(dup_frac=0.3)),
    ("compare_pushdown", {}),
    ("compare_pipeline", {}),
    ("compare_migration", dict(n_units=8)),
])
def test_compare_sweeps_match_reference(name, kw):
    want = getattr(JS, name)(n_batches=N_BATCHES, **kw)
    got = getattr(TS, name)(n_batches=N_BATCHES, **kw)
    _assert_bit_equal(got, want)


def test_calibrate_to_engine_matches_reference():
    util = np.array([0.31, 0.27, 0.45, 0.12])
    want = JS.calibrate_to_engine(util, n_batches=80, n_engines=4, n_units=4)
    got = TS.calibrate_to_engine(util, n_batches=80, n_engines=4, n_units=4)
    assert got["cfg"].__dict__ == want["cfg"].__dict__
    _assert_bit_equal({k: v for k, v in got.items() if k != "cfg"},
                      {k: v for k, v in want.items() if k != "cfg"})


def test_calibrates_to_port_pool_utilization():
    specs = (TableSpec("a", 500, nnz=4),
             TableSpec("b", 300, nnz=2, pooling="mean"),
             TableSpec("c", 40, nnz=1))
    tables = make_fused_tables(specs, 16, 4)
    rng = np.random.default_rng(0)
    tnp = rng.normal(size=(tables.total_rows, 16)).astype(np.float32)
    svc = PooledLookupService(tables, tnp, num_threads=4)
    try:
        for _ in range(6):
            b = syn.recsys_batch(rng, tables.specs, 32)
            svc.lookup(b["indices"], b["mask"])
        util = svc.pool.utilization()
    finally:
        svc.close()
    assert (util >= 0).all() and (util <= 1).all()
    cal = TS.calibrate_to_engine(util, n_batches=150, n_engines=4, n_units=4)
    assert abs(cal["achieved_utilization"]
               - cal["target_utilization"]) < 0.1, cal


@pytest.mark.parametrize("seed, n_servers, n_engines", [
    (0, 8, 2), (7, 16, 4), (19, 32, 2), (30, 32, 4),
])
def test_mapping_aware_never_slower(seed, n_servers, n_engines):
    """The property of tests/test_simulator_properties.py on the port, at
    four of its draws."""
    base = dict(n_servers=n_servers, n_engines=n_engines, n_units=n_engines,
                n_batches=200, seed=seed)
    naive = TS.LookupSimulator(TS.SimConfig(mapping_aware=False,
                                            **base)).run()
    aware = TS.LookupSimulator(TS.SimConfig(mapping_aware=True, **base)).run()
    assert aware["throughput_batches_per_s"] >= \
        0.98 * naive["throughput_batches_per_s"]


@pytest.mark.parametrize("seed", [0, 13])
def test_simulator_conserves_batches(seed):
    out = TS.LookupSimulator(TS.SimConfig(n_batches=100, seed=seed)).run()
    assert out["makespan_s"] > 0
    assert out["throughput_batches_per_s"] * out["makespan_s"] == \
        np.float64(100)
