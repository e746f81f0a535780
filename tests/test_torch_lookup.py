"""The port's DisaggEmbedding.lookup against the reference's when table rows
that the lookup must not read hold NaN or Inf, and K1's two modes and launch
plan, on the CPU.

The reference never adds a masked slot's row: its masked gather
(``repro/core/embedding.py::_gather_masked``) is ``where(hit, rows, 0)``, in
``lookup_reference`` and in the mesh and cached path (``_shard_local``).  A
hot-cache hit is served from the cache, so its table row is not read either.
The port's lookup runs K1 in its masked mode, which skips zero-weight slots
(``kernels/ref.py::embedding_bag_ref(masked=True)`` on the CPU).

Tolerances: pooled rows rtol 1e-5, atol 1e-6 (as tests/test_hotcache.py);
K1's plain versions against the reference's gather and the Pallas kernel
rtol = atol = 1e-5 (f32 sums in another order).
"""
import contextlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.embedding import DisaggEmbedding as JaxEmbedding
from repro.core.embedding import make_cache_from_table as jax_make_cache
from repro.core.embedding import make_hash_cache_from_table as jax_make_hash_cache
from repro.core.sharding import TableSpec as JaxTableSpec
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro_torch.core.embedding import (
    DisaggEmbedding,
    make_cache_from_table,
    make_hash_cache_from_table,
)
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.hotcache import kernels as HK
from repro_torch.hotcache import table as T
from repro_torch.kernels import build, ops
from repro_torch.kernels import embedding_bag as K1
from repro_torch.models import recsys as R

SPECS = [("a", 997, 4, "sum"), ("b", 512, 2, "mean"), ("c", 33, 1, "sum")]
BAD = {"nan": np.nan, "inf": np.inf}


def _setup(replicated=()):
    """Both packages' layers over SPECS at dim 16, the reference's params as
    numpy, 8 requests and 200 hot fused ids, all from seed 0."""
    rng = np.random.default_rng(0)
    jspecs = [JaxTableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS]
    tspecs = [TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS]
    jemb = JaxEmbedding(specs=jspecs, dim=16, num_shards=1, replicated_fields=replicated)
    temb = DisaggEmbedding(specs=tspecs, dim=16, num_shards=1,
                           replicated_fields=replicated)
    np_params = jax.tree_util.tree_map(np.asarray, jemb.init(jax.random.key(0)))
    b = syn.recsys_batch(rng, temb.specs, 8)
    hot = rng.choice(jemb.sharded.raw_rows, 200, replace=False)
    return jemb, temb, {k: v.copy() for k, v in np_params.items()}, b, hot


def _fused(temb, key, b):
    """(fused row ids [B, Fg, nnz], mask) of the group stored under ``key``."""
    tables, fields = ((temb.sharded, temb.sharded_idx) if key == "table"
                      else (temb.replicated, temb.replicated_idx))
    idx = torch.from_numpy(b["indices"][:, list(fields)])
    return temb._fused_rows(tables, idx).numpy(), b["mask"][:, list(fields)]


def _plant_behind_padding(temb, np_params, b, value) -> int:
    """``value`` in every table row that only masked slots point to."""
    planted = 0
    for key in np_params:
        fused, m = _fused(temb, key, b)
        rows = np.setdiff1d(fused[~m], fused[m])
        np_params[key][rows] = value
        planted += len(rows)
    return planted


def _lookups(jemb, temb, np_params, b, mesh, jcache=None, tcache=None):
    """(reference, port) pooled [B, F, D] of one batch."""
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    want = jemb.lookup(jparams, jnp.asarray(b["indices"]), jnp.asarray(b["mask"]),
                       mesh=mesh, cache=jcache)
    got = temb.lookup(R.params_from_numpy(np_params, "cpu"),
                      torch.from_numpy(b["indices"]), torch.from_numpy(b["mask"]),
                      cache=tcache)
    return np.asarray(want), got.numpy()


def _assert_finite_and_close(want, got):
    assert np.isfinite(want).all()  # the reference reads no planted row
    assert np.isfinite(got).all(), f"{int((~np.isfinite(got)).sum())} non-finite outputs"
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------- rows the lookup must skip


@pytest.mark.parametrize("bad", sorted(BAD))
@pytest.mark.parametrize("replicated", [(), (2,)], ids=["fused", "replicated"])
@pytest.mark.parametrize("on_mesh", [False, True], ids=["lookup", "mesh1x1"])
def test_uncached_lookup_skips_rows_behind_padding(on_mesh, replicated, bad, trivial_mesh):
    """NaN or Inf in the rows that only padding slots point to: the
    reference's lookup (its oracle, and the 1x1 mesh path) reads none of
    them, and neither does the port's."""
    jemb, temb, np_params, b, _ = _setup(replicated)
    assert _plant_behind_padding(temb, np_params, b, BAD[bad]) > 0
    want, got = _lookups(jemb, temb, np_params, b, trivial_mesh if on_mesh else None)
    _assert_finite_and_close(want, got)


def _plant_behind_hits(temb, np_params, b, is_hit, value) -> int:
    """``value`` in the sharded table's rows of the batch's cache hits (the
    caches were built from the finite rows)."""
    fused, m = _fused(temb, "table", b)
    hits = is_hit(fused) & m
    rows = np.unique(fused[hits])
    assert not np.isin(rows, fused[m & ~hits]).any()  # a row hits or misses, never both
    np_params["table"][rows] = value
    return len(rows)


@pytest.mark.parametrize("bad", sorted(BAD))
def test_hash_cached_lookup_skips_rows_of_hits(bad, trivial_mesh):
    """NaN or Inf in the table rows of the hash cache's hits and behind the
    padding slots: the reference's cached lookup (mesh 1x1) serves hits from
    the cache and reads neither, nor does the port's."""
    jemb, temb, np_params, b, hot = _setup()
    jcache = jax_make_hash_cache(jemb, jax.tree_util.tree_map(jnp.asarray, np_params),
                                 hot, 512, mesh=trivial_mesh)
    tcache = make_hash_cache_from_table(temb, R.params_from_numpy(np_params, "cpu"),
                                        hot, 512, device="cpu")

    def is_hit(fused):
        return T.cache_lookup(tcache, torch.from_numpy(fused), 8)[1].numpy()

    assert _plant_behind_hits(temb, np_params, b, is_hit, BAD[bad]) > 0
    _plant_behind_padding(temb, np_params, b, BAD[bad])
    want, got = _lookups(jemb, temb, np_params, b, trivial_mesh, jcache, tcache)
    _assert_finite_and_close(want, got)


@pytest.mark.parametrize("bad", sorted(BAD))
def test_flat_cached_lookup_skips_rows_of_hits(bad, trivial_mesh):
    """As the hash cache, with the flat sorted slab."""
    jemb, temb, np_params, b, hot = _setup()
    jcache = jax_make_cache(jemb, jax.tree_util.tree_map(jnp.asarray, np_params), hot,
                            256, mesh=trivial_mesh)
    tcache = make_cache_from_table(temb, R.params_from_numpy(np_params, "cpu"), hot,
                                   256, device="cpu")
    ids = tcache.ids.numpy()
    assert _plant_behind_hits(temb, np_params, b, lambda f: np.isin(f, ids), BAD[bad]) > 0
    _plant_behind_padding(temb, np_params, b, BAD[bad])
    want, got = _lookups(jemb, temb, np_params, b, trivial_mesh, jcache, tcache)
    _assert_finite_and_close(want, got)


# ------------------------------------------------ K1's plain versions


def _bags_with_bad_rows(rng, V, D, bags, nnz, value):
    """A table, ids (some out of [0, V)) and 0/1 or fractional weights, with
    ``value`` in the rows that only zero-weight slots point to."""
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(-3, V + 3, bags * nnz).astype(np.int32)
    w = np.where(rng.random(bags * nnz) < 0.4, 0.0, rng.random(bags * nnz) + 0.5)
    w = w.astype(np.float32)
    clamped = np.clip(ids, 0, V - 1)
    table[np.setdiff1d(clamped[w == 0], clamped[w != 0])] = value
    return table, ids, w


@pytest.mark.parametrize("bad", sorted(BAD))
@pytest.mark.parametrize("nnz", [1, 3, 4, 8])
def test_masked_plain_version_matches_reference_masked_gather(nnz, bad):
    """K1's masked plain version against the reference's masked gather
    (``_gather_masked`` with hit = w != 0, times w, summed over the bag);
    the weighted one gives non-finite bags exactly where a zero-weight slot
    holds a bad row, as the Pallas kernel's contract does."""
    rng = np.random.default_rng(nnz)
    V, D, bags = 50, 16, 24
    table, ids, w = _bags_with_bad_rows(rng, V, D, bags, nnz, BAD[bad])
    rows = JaxEmbedding._gather_masked(jnp.asarray(table), jnp.asarray(ids.reshape(bags, nnz)),
                                       jnp.asarray(w.reshape(bags, nnz) != 0))
    want = np.asarray((rows * jnp.asarray(w.reshape(bags, nnz, 1))).sum(axis=1))
    args = (torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(w), bags)
    got = ops.embedding_bag(*args, masked=True)
    assert np.isfinite(want).all() and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    weighted = ops.embedding_bag(*args).numpy()
    clamped = np.clip(ids, 0, V - 1).reshape(bags, nnz)
    bad_bag = (~np.isfinite(table[clamped]).all(-1)).any(-1)
    np.testing.assert_array_equal(~np.isfinite(weighted).all(-1), bad_bag)
    assert bad_bag.any()


@pytest.mark.parametrize("nnz", [1, 3, 4, 5, 8])
def test_masked_mode_equals_weighted_on_finite_rows(nnz):
    """On finite rows the two modes agree: a skipped slot and 0 x row add
    the same 0 (up to the sign of a zero, hence allclose)."""
    rng = np.random.default_rng(10 + nnz)
    table, ids, w = _bags_with_bad_rows(rng, 40, 24, 10, nnz, 0.5)
    args = (torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(w), 10)
    np.testing.assert_allclose(ops.embedding_bag(*args, masked=True).numpy(),
                               ops.embedding_bag(*args).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nnz", [3, 5])
def test_embedding_bag_odd_nnz_matches_pallas(nnz):
    """ops.embedding_bag (weighted) against the Pallas kernel in interpret
    mode at nnz that no unrolled loop takes."""
    rng = np.random.default_rng(nnz)
    V, D, bags = 96, 128, 6
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, bags * nnz).astype(np.int32)
    w = (rng.random(bags * nnz) > 0.25).astype(np.float32)
    want = jax_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), bags,
                   interpret=True)
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(w), bags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ launch plan and wrappers


@pytest.mark.parametrize("bags,nnz,dim,vec,floats,want", [
    # dlrm-flexemr's forward: 2048 x 26 bags of 4 slots, D 64 f32 -> 16 lanes,
    # 16 groups a block, the unrolled nnz-4 path, capped at one wave of 132 x 6
    # blocks; K1 takes one bag a pass, K3 (16 f32 sums a lane) 4 bags: 16 slots.
    (53_248, 4, 64, 4, 0, K1.LaunchPlan(4, 16, 4, 1, 792)),
    (53_248, 4, 64, 4, 16, K1.LaunchPlan(4, 16, 4, 4, 792)),
    (53_248, 1, 64, 4, 16, K1.LaunchPlan(4, 16, 1, 4, 792)),  # the sums bound it
    (10, 4, 64, 4, 0, K1.LaunchPlan(4, 16, 4, 1, 1)),  # fewer bags than a block's
    (10, 4, 64, 4, 16, K1.LaunchPlan(4, 16, 4, 4, 1)),
    (33, 4, 64, 8, 16, K1.LaunchPlan(8, 8, 4, 2, 1)),  # bf16 D 64: 8 lanes, 2 bags of 8 sums
    (33, 8, 64, 8, 16, K1.LaunchPlan(8, 8, 8, 1, 2)),  # 8 slots fill the 8 lanes
    (33, 16, 64, 8, 16, K1.LaunchPlan(8, 8, 0, 1, 2)),  # nnz above the lanes: general loop
    (100, 3, 64, 4, 16, K1.LaunchPlan(4, 16, 0, 1, 7)),  # nnz 3 is not unrolled
    (100, 2, 256, 4, 0, K1.LaunchPlan(4, 32, 2, 1, 13)),  # 64 vectors a row: 32 lanes
    (100, 2, 256, 4, 16, K1.LaunchPlan(4, 32, 2, 4, 4)),
    (100, 4, 17, 1, 16, K1.LaunchPlan(1, 32, 0, 1, 13)),  # element loads: general loop only
    (100, 4, 4, 4, 0, K1.LaunchPlan(4, 1, 0, 1, 1)),  # one vector a row, nnz above 1 lane
])
def test_launch_plan(bags, nnz, dim, vec, floats, want):
    asked = []

    def resident(spec):
        asked.append(spec)
        return 132 * 6

    assert K1.launch_plan(bags, nnz, dim, vec, resident, floats) == want
    assert asked == [want.nnz_spec]  # the occupancy of the kernel that runs


@pytest.mark.parametrize("dtype,dim,aligned,want", [
    (torch.float32, 64, True, 4), (torch.bfloat16, 64, True, 8),
    (torch.float32, 66, True, 1), (torch.bfloat16, 68, True, 1),
    (torch.float32, 64, False, 1),
])
def test_vec_width(dtype, dim, aligned, want):
    assert K1.vec_width(dtype, dim, aligned) == want


class _FakeLib:
    """Stands in for a kernel library: records each launch's arguments and
    answers the occupancy query with 6 blocks an SM."""

    _name = "libfake.so"

    def __init__(self, prefix):
        self.prefix, self.calls, self.occupancy = prefix, [], []

    def __getattr__(self, sym):
        if not sym.startswith(self.prefix):
            raise AttributeError(sym)
        if "_occupancy_" in sym:
            return lambda *args: self.occupancy.append((sym, args)) or 6
        return lambda *args: self.calls.append((sym, args)) or 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA branches of the K1 and K3 wrappers on CPU tensors, with the
    libraries, the device, the stream and the SM count faked."""
    libs = {K1.NAME: _FakeLib(K1.NAME), HK.PROBE: _FakeLib(HK.PROBE)}
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    monkeypatch.setattr(HK, "_is_cuda", lambda t: True)
    monkeypatch.setattr(K1, "_on_cuda", lambda t: True)
    monkeypatch.setattr(K1, "_occupancy", {})
    monkeypatch.setattr(K1, "sm_count", lambda dev: 132)
    monkeypatch.setattr(build, "load", lambda name, sigs: libs[name])
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=77))
    before = (K1.launches, dict(HK.launches))
    yield libs
    K1.launches, HK.launches[HK.PROBE] = before[0], before[1][HK.PROBE]


def _k1_launches(lib):
    """(masked, [num_bags, nnz, dim, V, vec, lanes, nnz_spec, blocks]) per launch."""
    return [(a[11], list(a[4:11]) + [a[12]]) for _, a in lib.calls]


def test_lookup_launches_k1_masked_and_bag_lookup_weighted(fake_cuda):
    """DisaggEmbedding.lookup launches K1 in its masked mode, one launch a
    group; ops.bag_lookup and ops.embedding_bag in the weighted mode."""
    _, temb, np_params, b, _ = _setup((2,))
    before = K1.launches
    temb.lookup(R.params_from_numpy(np_params, "cpu"), torch.from_numpy(b["indices"]),
                torch.from_numpy(b["mask"]))
    lib = fake_cuda[K1.NAME]
    V, V_rep = np_params["table"].shape[0], np_params["rep_table"].shape[0]
    assert _k1_launches(lib) == [(1, [8 * 2, 4, 16, V, 4, 4, 4, 1]),
                                 (1, [8 * 1, 4, 16, V_rep, 4, 4, 4, 1])]
    assert [s for s, _ in lib.calls] == ["embedding_bag_f32"] * 2
    lib.calls.clear()
    table = torch.zeros(50, 64)
    ops.bag_lookup(table, torch.zeros(3, 2, 4, dtype=torch.int32),
                   torch.ones(3, 2, 4, dtype=torch.bool))
    ops.embedding_bag(table.to(torch.bfloat16), torch.zeros(6, dtype=torch.int32),
                      torch.ones(6), 6)
    assert _k1_launches(lib) == [(0, [6, 4, 64, 50, 4, 16, 4, 1]),
                                 (0, [6, 1, 64, 50, 8, 8, 1, 1])]
    assert [s for s, _ in lib.calls] == ["embedding_bag_f32", "embedding_bag_bf16"]
    assert K1.launches == before + 4


def test_wrappers_launch_one_wave_from_the_occupancy(fake_cuda):
    """Many bags: K1 and K3 launch SMs x the kernel's blocks an SM holds,
    asking the library once per kernel."""
    bags = 132 * 6 * 64 * 2  # K1: six waves of 16 bags a block, K3: two of 64
    table = torch.zeros(1000, 64)
    ids = torch.zeros(bags * 4, dtype=torch.int32)
    w = torch.ones(bags * 4)
    for _ in range(2):
        K1.embedding_bag(table, ids, w, bags, masked=True)
    lib = fake_cuda[K1.NAME]
    assert _k1_launches(lib) == [(1, [bags, 4, 64, 1000, 4, 16, 4, 132 * 6])] * 2
    assert lib.occupancy == [("embedding_bag_occupancy_f32", (4, 4, 1))]
    keys = torch.full((1 << 10,), T.EMPTY_KEY, dtype=torch.int32)
    values = torch.zeros(1 << 10, 64, dtype=torch.bfloat16)
    HK.probe_gather_pool(keys, values, ids, w, bags, 8)
    (sym, a), = fake_cuda[HK.PROBE].calls
    assert sym == "probe_gather_pool_bf16"
    # num_bags, nnz, dim, C, shift, max_probes, vec, lanes, nnz_spec, pass_bags,
    # blocks, stream
    assert a[6:] == (bags, 4, 64, 1 << 10, 33 - 11, 8, 8, 8, 4, 2, 132 * 6, 77)
    assert fake_cuda[HK.PROBE].occupancy == [("probe_gather_pool_occupancy_bf16", (8, 4))]


@pytest.mark.parametrize("name,symbols", [
    (K1.NAME, list(K1._SYMBOLS.values()) + list(K1._OCC_SYMBOLS.values())),
    (HK.PROBE, list(HK._PROBE_SYMBOLS.values()) + list(HK._PROBE_OCC_SYMBOLS.values())),
])
def test_launch_and_occupancy_symbols_exist_in_source(name, symbols):
    """Every launch and occupancy function the K1 and K3 wrappers bind is
    exported by its .cu source."""
    src = (build.CSRC / f"{name}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(symbols) <= exported


def test_resident_blocks_asks_each_library_once_and_raises_on_error(monkeypatch):
    """One occupancy query per (library file, symbol, device, arguments),
    times the SM count; a negative answer (a CUDA error) raises."""
    monkeypatch.setattr(K1, "_occupancy", {})
    monkeypatch.setattr(K1, "sm_count", lambda dev: 132)
    asked = []
    lib = types.SimpleNamespace(_name="liba.so", occ=lambda *a: asked.append(a) or 5)
    dev = torch.device("cpu")
    assert K1.resident_blocks(lib, K1.NAME, "occ", dev, 4, 4, 1) == 660
    assert K1.resident_blocks(lib, K1.NAME, "occ", dev, 4, 4, 1) == 660
    assert K1.resident_blocks(lib, K1.NAME, "occ", dev, 4, 0, 1) == 660
    assert asked == [(4, 4, 1), (4, 0, 1)]
    other = types.SimpleNamespace(_name="libb.so", occ=lambda *a: asked.append(a) or 3)
    assert K1.resident_blocks(other, K1.NAME, "occ", dev, 4, 4, 1) == 396
    codes = []
    monkeypatch.setattr(build, "check", lambda lib_, name, code: codes.append(code) or (
        _ for _ in ()).throw(RuntimeError(f"CUDA error {code}")))
    bad = types.SimpleNamespace(_name="libc.so", occ=lambda *a: -98)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        K1.resident_blocks(bad, K1.NAME, "occ", dev, 4, 4, 1)
    assert codes == [98]
