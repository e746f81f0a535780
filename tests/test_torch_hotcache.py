"""repro_torch's device hot cache (hotcache/table, kernels K3/K4 and the
cached lookup) against the JAX package, on the CPU.

On the CPU the kernel entry points take their plain versions (hotcache/ref.py);
chip_smoke.py holds the CUDA kernels against those on the card.  Tolerances:
  * bit-equal: hash slots, keys, freq, rows and admitted after inserts, miss
    masks, K4's output;
  * pooled rows rtol = atol = 1e-5 (f32 sums in another order);
  * the cached lookup rtol 1e-5, atol 1e-6 (as tests/test_hotcache.py);
  * DLRM scores rtol 1e-4, atol 1e-5 (BLAS summation order).
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
from repro.hotcache import ref as JREF
from repro.hotcache import table as JT
from repro.hotcache.kernels import probe_gather_pool as jax_probe
from repro.hotcache.kernels import scatter_update as jax_scatter
from repro.models import recsys as JR
from repro_torch.core.embedding import (
    DisaggEmbedding,
    empty_cache,
    make_cache_from_table,
    make_hash_cache_from_table,
)
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.hotcache import kernels as HK
from repro_torch.hotcache import ref as HREF
from repro_torch.hotcache import table as T
from repro_torch.kernels import build
from repro_torch.models import recsys as R

EMPTY = JT.EMPTY_KEY


def _port_state(jstate):
    return T.hash_cache_from_numpy(np.asarray(jstate.keys), np.asarray(jstate.rows),
                                   np.asarray(jstate.freq), "cpu")


def _assert_state_equal(got: T.HashCacheState, want) -> None:
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    np.testing.assert_array_equal(got.freq.numpy(), np.asarray(want.freq))
    np.testing.assert_array_equal(got.rows.float().numpy(),
                                  np.asarray(want.rows).astype(np.float32))


# ------------------------------------------------------------- hash geometry


@pytest.mark.parametrize("C", [1, 16, 256, 4096])
def test_hash_slots_match_reference(C):
    ids = np.concatenate([np.arange(1000), [2**31 - 2, EMPTY]]).astype(np.int32)
    got = T.hash_slots(torch.from_numpy(ids), C).numpy()
    np.testing.assert_array_equal(got, np.asarray(JT.hash_slots(jnp.asarray(ids), C)))
    np.testing.assert_array_equal(got, JT.hash_slots_np(ids, C))
    np.testing.assert_array_equal(T.hash_slots_np(ids, C), got)
    np.testing.assert_array_equal(
        T.probe_slots(torch.from_numpy(ids), C, 4).numpy(),
        np.asarray(JT.probe_slots(jnp.asarray(ids), C, 4)))


# --------------------------------------------------------------- LFU insert


def _insert_both(C, D, P, ids, rows, freqs, thr, chunks=2):
    """The same insert stream through both packages, in ``chunks`` calls."""
    jstate = JT.empty_hash_cache(C, D)
    tstate = T.empty_hash_cache(C, D, device="cpu")
    for part in np.array_split(np.arange(len(ids)), chunks):
        jstate, j_adm = JT.cache_insert(
            jstate, jnp.asarray(ids[part]), jnp.asarray(rows[part]),
            jnp.asarray(freqs[part]), thr, max_probes=P)
        before = tstate
        tstate, t_adm = T.cache_insert(
            tstate, torch.from_numpy(ids[part]), torch.from_numpy(rows[part]),
            torch.from_numpy(freqs[part]), thr, max_probes=P)
        np.testing.assert_array_equal(t_adm.numpy(), np.asarray(j_adm))
        assert before.rows.data_ptr() != tstate.rows.data_ptr()  # functional
    return jstate, tstate


@pytest.mark.parametrize("thr", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cache_insert_bit_equal_with_reference(seed, thr):
    """Seeded streams with duplicate ids: keys, freq, rows and admitted are
    bit-equal with the reference's fori_loop insert (C = 64, P = 4)."""
    rng = np.random.default_rng(seed)
    C, D, P, n = 64, 8, 4, 150
    ids = rng.integers(0, 500, n).astype(np.int32)
    rows = rng.normal(size=(n, D)).astype(np.float32)
    freqs = rng.integers(1, 12, n).astype(np.int32)
    jstate, tstate = _insert_both(C, D, P, ids, rows, freqs, thr)
    _assert_state_equal(tstate, jstate)
    assert int(tstate.occupancy()) == int(jstate.occupancy())


def _colliding_ids(C, n, start=0):
    """n ids whose probe windows all share one home slot (true collisions)."""
    home = T.hash_slots_np(np.arange(start, start + 200_000), C)
    ids = np.flatnonzero(home == home[0])[:n] + start
    assert len(ids) == n, "not enough colliding ids in range"
    return ids


def test_cache_insert_colliding_ids_bit_equal():
    """Ids that share one probe window: vacant fill, admission gate, LFU
    eviction, tie keeps the incumbent, refresh of a resident id."""
    C, D, P = 64, 8, 4
    base = _colliding_ids(C, P + 3)
    ids = np.concatenate([base[:P], base[P:], base[:2], base[P + 2:]]).astype(np.int32)
    freqs = np.array([10, 11, 12, 13, 5, 10, 99, 2, 3, 1], np.int32)
    rows = np.random.default_rng(4).normal(size=(len(ids), D)).astype(np.float32)
    for thr in (1, 3):
        jstate, tstate = _insert_both(C, D, P, ids, rows, freqs, thr, chunks=3)
        _assert_state_equal(tstate, jstate)


def test_decay_freq_and_cache_lookup_bit_equal(rng):
    C, D, P = 128, 16, 8
    ids = rng.integers(0, 5000, 200).astype(np.int32)
    jstate = JT.empty_hash_cache(C, D)
    jstate, _ = JT.cache_insert(
        jstate, jnp.asarray(ids), jnp.asarray(rng.normal(size=(200, D)).astype(np.float32)),
        jnp.asarray(rng.integers(1, 1000, 200).astype(np.int32)), 2, max_probes=P)
    tstate = _port_state(jstate)
    for factor in (0.97, 0.5):
        np.testing.assert_array_equal(T.decay_freq(tstate, factor).freq.numpy(),
                                      np.asarray(JT.decay_freq(jstate, factor).freq))
    q = np.concatenate([ids[:50], rng.integers(0, 10_000, 50), [EMPTY]]).astype(np.int32)
    want_rows, want_hit = JT.cache_lookup(jstate, jnp.asarray(q), max_probes=P)
    got_rows, got_hit = T.cache_lookup(tstate, torch.from_numpy(q), max_probes=P)
    np.testing.assert_array_equal(got_hit.numpy(), np.asarray(want_hit))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))


# ------------------------------------------------------ K3 probe_gather_pool


def _filled_cache(rng, C, D, P, dtype=jnp.float32):
    """A reference cache 60% full (random ids, random freqs)."""
    n = int(C * 0.6)
    ins = rng.choice(100_000, n, replace=False).astype(np.int32)
    state, _ = JT.cache_insert(
        JT.empty_hash_cache(C, D, dtype), jnp.asarray(ins),
        jnp.asarray(rng.normal(size=(n, D)).astype(np.float32)),
        jnp.asarray(rng.integers(1, 9, n).astype(np.int32)), 1, max_probes=P)
    return state, ins


def _queries(rng, ins, n):
    """~60% resident ids, the rest cold, ~10% EMPTY_KEY; weights in [0, 1)
    with ~20% masked."""
    q = rng.choice(ins, n).astype(np.int32)
    cold = rng.random(n) < 0.4
    q[cold] = rng.integers(200_000, 300_000, int(cold.sum()))
    q[rng.random(n) < 0.1] = EMPTY
    w = np.where(rng.random(n) > 0.2, rng.random(n), 0.0).astype(np.float32)
    return q, w


@pytest.mark.parametrize("C,D,bags,nnz,P,dtype", [
    (64, 128, 4, 1, 4, "f32"), (256, 128, 16, 4, 8, "f32"),
    (512, 256, 8, 8, 8, "f32"), (256, 128, 16, 4, 8, "bf16"),
])
def test_probe_gather_pool_matches_pallas_and_ref(C, D, bags, nnz, P, dtype, rng):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    state, ins = _filled_cache(rng, C, D, P, jdt)
    q, w = _queries(rng, ins, bags * nnz)
    tstate = _port_state(state)
    assert tstate.rows.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    got_pooled, got_miss = HK.probe_gather_pool(
        tstate.keys, tstate.rows, torch.from_numpy(q), torch.from_numpy(w), bags, P)
    assert got_pooled.dtype == torch.float32 and got_pooled.shape == (bags, D)
    assert got_miss.dtype == torch.bool and got_miss.shape == (bags * nnz,)
    for want_pooled, want_miss in (
        jax_probe(state.keys, state.rows, jnp.asarray(q), jnp.asarray(w), bags,
                  max_probes=P, interpret=True),
        JREF.probe_gather_pool_ref(state.keys, state.rows, jnp.asarray(q),
                                   jnp.asarray(w), bags, P),
    ):
        np.testing.assert_array_equal(got_miss.numpy(), np.asarray(want_miss))
        np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled),
                                   rtol=1e-5, atol=1e-5)


def test_probe_gather_pool_small_table_counts_each_hit_once(rng):
    """C < max_probes: the window repeats slots.  The port pools a hit once,
    as the reference's oracle does (its Pallas kernel pools it once per
    repeat, so it is not compared here)."""
    C, D, P, bags, nnz = 4, 16, 8, 6, 3
    state, ins = _filled_cache(rng, C, D, P)
    q, w = _queries(rng, ins, bags * nnz)
    tstate = _port_state(state)
    got_pooled, got_miss = HK.probe_gather_pool(
        tstate.keys, tstate.rows, torch.from_numpy(q), torch.from_numpy(w), bags, P)
    want_pooled, want_miss = JREF.probe_gather_pool_ref(
        state.keys, state.rows, jnp.asarray(q), jnp.asarray(w), bags, P)
    np.testing.assert_array_equal(got_miss.numpy(), np.asarray(want_miss))
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled),
                               rtol=1e-5, atol=1e-5)
    assert (~got_miss).any()


# ----------------------------------------------------------- K4 scatter_update


@pytest.mark.parametrize("vdt", ["f32", "bf16"])
def test_scatter_update_unique_slots_matches_pallas(vdt, rng):
    """f32 rows into f32 or bf16 values: both round to nearest even."""
    C, D, K = 128, 128, 32
    jdt, tdt = (jnp.float32, torch.float32) if vdt == "f32" else (jnp.bfloat16, torch.bfloat16)
    vals = rng.normal(size=(C, D)).astype(np.float32)
    slots = rng.choice(C, K, replace=False).astype(np.int32)
    rows = rng.normal(size=(K, D)).astype(np.float32)
    want = jax_scatter(jnp.asarray(vals, jdt), jnp.asarray(slots), jnp.asarray(rows),
                       interpret=True)
    values = torch.from_numpy(vals).to(tdt)
    got = HK.scatter_update(values, torch.from_numpy(slots), torch.from_numpy(rows))
    assert got is values  # updated in place, as the aliased Pallas output
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    np.testing.assert_array_equal(
        HREF.scatter_update_ref(torch.from_numpy(vals).to(tdt), torch.from_numpy(slots),
                                torch.from_numpy(rows)).float().numpy(),
        got.float().numpy())


def test_scatter_update_repeated_slots_last_write_wins(rng):
    C, D, K = 32, 24, 200
    vals = rng.normal(size=(C, D)).astype(np.float32)
    slots = rng.integers(-2, C + 2, K).astype(np.int32)  # repeats + out of range
    rows = rng.normal(size=(K, D)).astype(np.float32)
    want = vals.copy()
    for i, s in enumerate(slots):  # sequential: later writes win
        if 0 <= s < C:
            want[s] = rows[i]
    got = HK.scatter_update(torch.from_numpy(vals.copy()), torch.from_numpy(slots),
                            torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_winner_scratch_is_kept_per_device_stream_and_size(monkeypatch):
    """K4's winner scratch: int32 zeros made once per (device, stream, C);
    each call's words start where the last call's ended, from 1."""
    monkeypatch.setattr(HK, "_winners", {})
    dev = torch.device("cpu")
    a, b1 = HK.winner_scratch(dev, 7, 16, 5)
    b, b2 = HK.winner_scratch(dev, 7, 16, 3)
    assert a is b and (b1, b2) == (1, 6)
    assert a.dtype == torch.int32 and a.shape == (16,) and not a.any()
    other_stream, base = HK.winner_scratch(dev, 8, 16, 5)
    assert other_stream is not a and base == 1
    other_size, base = HK.winner_scratch(dev, 7, 32, 5)
    assert other_size is not a and other_size.shape == (32,) and base == 1
    assert HK.winner_scratch(dev, 7, 16, 1) == (a, 9)


def test_winner_scratch_is_zeroed_before_the_words_wrap(monkeypatch):
    """A call whose last word would pass 2^32 - 1 zeroes the scratch first
    and starts again at 1; one that ends exactly at 2^32 - 1 does not."""
    monkeypatch.setattr(HK, "_winners", {})
    dev = torch.device("cpu")
    scratch, _ = HK.winner_scratch(dev, 0, 8, 1)
    scratch.fill_(-5)  # words left by earlier calls (2^32 - 5 as unsigned)
    HK._winners[(dev, 0, 8)][1] = HK.MAX_WORD - 9
    same, base = HK.winner_scratch(dev, 0, 8, 10)
    assert same is scratch and base == HK.MAX_WORD - 9 and scratch.all()
    same, base = HK.winner_scratch(dev, 0, 8, 1)
    assert same is scratch and base == 1 and not scratch.any()
    assert HK.winner_scratch(dev, 0, 8, 4)[1] == 2


class _FakeScatterLib:
    """Stands in for libscatter_update: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, sym):
        if not sym.startswith(HK.SCATTER):
            raise AttributeError(sym)
        return lambda *args: self.calls.append((sym, args)) or 0


def test_scatter_update_passes_one_scratch_and_rising_bases(monkeypatch):
    """The CUDA branch of the K4 wrapper, with the library and the CUDA
    calls faked: no fill, the same scratch of the right size every call on
    one stream, bases 1, 1 + K, ..., and the launch counted."""
    lib = _FakeScatterLib()
    monkeypatch.setattr(HK, "_winners", {})
    monkeypatch.setattr(HK, "_is_cuda", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(torch, "full", None)  # no fill: the wrapper must not call it
    before = HK.launches[HK.SCATTER]
    values = torch.zeros(64, 8)
    slots = torch.tensor([3, 9, 3], dtype=torch.int32)
    rows = torch.ones(3, 8, dtype=torch.bfloat16)
    for _ in range(2):
        assert HK.scatter_update(values, slots, rows) is values
    (sym1, a1), (sym2, a2) = lib.calls
    assert sym1 == sym2 == "scatter_update_f32_bf16"
    scratch = HK._winners[(values.device, 1234, 64)][0]
    assert a1[3] == a2[3] == scratch.data_ptr() and scratch.shape == (64,)
    assert a1[4:] == (3, 64, 8, 1, 1234) and a2[4:] == (3, 64, 8, 4, 1234)
    assert HK.launches[HK.SCATTER] == before + 2
    HK.launches[HK.SCATTER] = before


# ------------------------------------------------------- the cached lookup


SPECS = [("a", 997, 4, "sum"), ("b", 512, 2, "mean"), ("c", 33, 1, "sum")]


def _lookup_setup(rng, replicated):
    jspecs = [JaxTableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS]
    tspecs = [TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS]
    jemb = JaxEmbedding(specs=jspecs, dim=16, num_shards=1, replicated_fields=replicated)
    temb = DisaggEmbedding(specs=tspecs, dim=16, num_shards=1,
                           replicated_fields=replicated)
    np_params = jax.tree_util.tree_map(np.asarray, jemb.init(jax.random.key(0)))
    b = syn.recsys_batch(rng, temb.specs, 8)
    hot = rng.choice(jemb.sharded.raw_rows, 200, replace=False)
    return jemb, temb, np_params, b, hot


def _lookups(jemb, temb, np_params, b, jcache, tcache, mesh):
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    want = jemb.lookup(jparams, jnp.asarray(b["indices"]), jnp.asarray(b["mask"]),
                       mesh=mesh, cache=jcache)
    got = temb.lookup(R.params_from_numpy(np_params, "cpu"),
                      torch.from_numpy(b["indices"]), torch.from_numpy(b["mask"]),
                      cache=tcache)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("replicated", [(), (2,)], ids=["fused", "replicated"])
def test_hash_cached_lookup_matches_reference(replicated, trivial_mesh, rng):
    """The port's lookup(cache=HashCacheState) against the reference's
    lookup(mesh=1x1, cache=...): the caches from make_hash_cache_from_table
    are bit-equal, the pooled embeddings allclose."""
    jemb, temb, np_params, b, hot = _lookup_setup(rng, replicated)
    jcache = jax_make_hash_cache(jemb, jax.tree_util.tree_map(jnp.asarray, np_params),
                                 hot, 512, mesh=trivial_mesh)
    tcache = make_hash_cache_from_table(temb, R.params_from_numpy(np_params, "cpu"),
                                        hot, 512, device="cpu")
    _assert_state_equal(tcache, jcache)
    _lookups(jemb, temb, np_params, b, jcache, tcache, trivial_mesh)


@pytest.mark.parametrize("replicated", [(), (2,)], ids=["fused", "replicated"])
def test_flat_cached_lookup_matches_reference(replicated, trivial_mesh, rng):
    jemb, temb, np_params, b, hot = _lookup_setup(rng, replicated)
    jcache = jax_make_cache(jemb, jax.tree_util.tree_map(jnp.asarray, np_params), hot,
                            256, mesh=trivial_mesh)
    tcache = make_cache_from_table(temb, R.params_from_numpy(np_params, "cpu"), hot,
                                   256, device="cpu")
    np.testing.assert_array_equal(tcache.ids.numpy(), np.asarray(jcache.ids))
    np.testing.assert_array_equal(tcache.rows.numpy(), np.asarray(jcache.rows))
    _lookups(jemb, temb, np_params, b, jcache, tcache, trivial_mesh)


def test_empty_caches_leave_lookup_unchanged(rng):
    _, temb, np_params, b, _ = _lookup_setup(rng, ())
    params = R.params_from_numpy(np_params, "cpu")
    idx, msk = torch.from_numpy(b["indices"]), torch.from_numpy(b["mask"])
    want = temb.lookup(params, idx, msk)
    for cache in (T.empty_hash_cache(64, 16, device="cpu"),
                  T.empty_hash_cache(0, 16, device="cpu"),
                  empty_cache(0, 16, device="cpu")):
        np.testing.assert_allclose(temb.lookup(params, idx, msk, cache=cache).numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-7)


def test_dlrm_forward_with_cache_matches_reference(trivial_mesh, rng):
    specs = [("a", 300, 4, "sum"), ("b", 120, 3, "mean"), ("c", 40, 1, "sum")]
    kw = dict(name="tiny", arch="dlrm", embed_dim=16, n_dense=5,
              bottom_mlp=(32, 16), mlp=(32, 8))
    jcfg = JR.RecsysConfig(
        tables=tuple(JaxTableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in specs), **kw)
    tcfg = R.RecsysConfig(
        tables=tuple(TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in specs), **kw)
    np_params = jax.tree_util.tree_map(np.asarray, JR.init_params(jcfg, jax.random.key(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = R.params_from_numpy(np_params, "cpu")
    b = syn.recsys_batch(rng, tcfg.tables, 24, n_dense=tcfg.n_dense)
    hot = rng.choice(tcfg.num_embedding_rows(), 150, replace=False)
    jcache = jax_make_hash_cache(jcfg.embedding(1), jparams["emb"], hot, 256,
                                 mesh=trivial_mesh)
    tcache = make_hash_cache_from_table(tcfg.embedding(), tparams["emb"], hot, 256,
                                        device="cpu")
    want = np.asarray(JR.forward(jcfg, jparams, {k: jnp.asarray(v) for k, v in b.items()},
                                 mesh=trivial_mesh, cache=jcache))
    got = R.forward(tcfg, tparams, {k: torch.from_numpy(v) for k, v in b.items()},
                    cache=tcache)
    assert got.shape == (24,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------- wrappers and devices


def test_cpu_tensors_never_launch(rng):
    before = dict(HK.launches)
    state = T.empty_hash_cache(16, 8, device="cpu")
    HK.probe_gather_pool(state.keys, state.rows, torch.zeros(4, dtype=torch.int32),
                         torch.ones(4), 2)
    HK.scatter_update(state.rows, torch.tensor([1, 1], dtype=torch.int32),
                      torch.ones(2, 8))
    assert HK.launches == before


def test_wrappers_reject_other_devices():
    """A device other than cuda, cpu and meta (the dry run's) raises, and so
    do tensors on two kinds of device."""
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        HK.probe_gather_pool(other, other, other, other, 1)
    with pytest.raises(ValueError, match="one device type"):
        HK.probe_gather_pool(torch.zeros(4, dtype=torch.int32, device="meta"),
                             torch.zeros(4, 8, device="meta"),
                             torch.zeros(2, dtype=torch.int32),
                             torch.zeros(2, device="meta"), 1)
    with pytest.raises(ValueError, match="one device type"):
        HK.scatter_update(torch.zeros(4, 8, device="meta"),
                          torch.zeros(2, dtype=torch.int32), torch.zeros(2, 8, device="meta"))


@pytest.mark.parametrize("name,symbols", [
    (HK.PROBE, HK._PROBE_SYMBOLS.values()),
    (HK.SCATTER, HK._SCATTER_SYMBOLS.values()),
])
def test_bound_symbols_exist_in_source(name, symbols):
    src = (build.CSRC / f"{name}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(symbols) | {f"{name}_error_string"} <= exported
    assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", build.library_path(name).name)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")


def test_empty_hash_cache_defaults_to_cuda_and_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.empty_hash_cache(16, 8)


def test_cache_builders_raise_without_gpu(no_gpu, rng):
    _, temb, np_params, _, hot = _lookup_setup(rng, ())
    params = R.params_from_numpy(np_params, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_hash_cache_from_table(temb, params, hot, 512)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_cache_from_table(temb, params, hot, 256)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        empty_cache(8, 16)
