"""The backward kernels K1' (``embedding_bag_backward``) and K2'
(``dot_interaction_backward``) without the card: their host-side plans,
numpy models of what their kernels do, their wrappers' launches (the
library faked) and refusals, on the CPU.

K1''s model runs the kernel's phases on the host: marks in a bitmap of the
rows, an open-addressed insert of each live slot's row (the kernel's hash
and table size), each entry's run start and each slot's place in its run
in a random order (the kernel's atomics decide those), then each run's
slots visited in slot order (by rank up to ``BWD_SORT_CAP`` slots, through
bitmap windows of ``BWD_WINDOW`` slots past that), w * grad_out rounded and
added in f32, and zeros into every row no
live slot names.  It must equal ``ref.embedding_bag_backward_ref`` on the
CPU bit for bit (that plain version adds in slot order too), whatever the
random order, leave the table at zero and start each launch on a clean
half of the bitmap.  Against
``jax.vjp`` of the reference's lookup (ids clamped, the masked gather's
``where``): rtol 1e-5, atol 1e-6 (f32, XLA's scatter-add order).

K2''s model walks the plan's blocks and threads and reads S = G + G^T from
the triangle as the kernel indexes it: every output written once, S
exactly G + G^T, and the result within 1e-5 of the plain version (f32 sums
in the kernel's order, without its FMA).
"""
import contextlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build, ref
from repro_torch.kernels import dot_interaction as K2
from repro_torch.kernels import embedding_bag as K1

RTOL, ATOL = 1e-5, 1e-6
SMS = 132  # an H100's SMs, as the fake device reports them


# ------------------------------------------------------------- K1' plan


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 26624, 212992, K1.MAX_SLOTS])
def test_backward_table_bits(n):
    """The least power of two with at least 2n entries (and 2 at least):
    an insert of every slot finds a free entry; 31 bits at MAX_SLOTS."""
    bits = K1.backward_table_bits(n)
    assert 1 <= bits <= 31 and (1 << bits) >= 2 * n
    assert bits == 1 or (1 << (bits - 1)) < 2 * n


@pytest.mark.parametrize("n,V", [(26624, 1_272_000), (26624, 16_777_216), (0, 1), (7, 33)])
def test_backward_scratch_sizes(n, V):
    """A flag line a block, two halves of a bit a row, the table's three
    arrays, n entries for the rest and four words a run; at 16,777,216 rows
    a half is 2 MB (2^19 words)."""
    sizes = K1.backward_scratch_sizes(n, V, 8 * SMS)
    table = 1 << K1.backward_table_bits(n)
    assert sizes == {"counters": K1.BWD_COUNTERS, "flags": 32 * 8 * SMS,
                     "bitmap": 2 * -(-V // 32), "keys": table,
                     "counts": table, "ebase": table, "elist": max(1, n),
                     "runs": 4 * max(1, n), "slot_entry": max(1, n), "list": max(1, n)}
    if V == 16_777_216:
        assert sizes["bitmap"] == 2 << 19


@pytest.mark.parametrize("per_sm", [0, 1, 2, 4, 16])
def test_backward_blocks_one_wave(per_sm):
    """One wave: the SMs times the blocks an SM holds, at least 1 and at
    most BWD_BLOCKS_PER_SM."""
    want = SMS * max(1, min(per_sm, K1.BWD_BLOCKS_PER_SM))
    assert K1.backward_blocks(SMS, per_sm) == want


def test_backward_state_numbers_launches_and_alternates_halves():
    """Each launch has a new number, never 0 (its barriers' flags), marks
    the clean half and clears the other half's words the launch before it
    marked, whatever the row counts in between."""
    h = K1.BackwardState()
    seen = []
    for words in (40, 7, 100, 100, 1):
        seen.append((h.epoch, h.parity, h.stale_words()))
        h = h.after(words)
    assert seen == [(1, 0, 0), (2, 1, 40), (3, 0, 7), (4, 1, 100), (5, 0, 100)]
    assert h == K1.BackwardState(6, 1, (1, 0))
    assert K1.BackwardState(epoch=0xFFFFFFFF).after(1).epoch == 1


def test_backward_scratch_is_kept_and_grown(monkeypatch):
    """One scratch per (device, stream): the same tensors on a second call,
    a part grown to twice its size at least when a launch needs more, the
    parts the kernel leaves at zero made as zeros, and a new bitmap's
    halves both clean."""
    monkeypatch.setattr(K1, "_bwd_scratch", {})
    monkeypatch.setattr(K1, "_bwd_state", {})
    dev = torch.device("cpu")
    K1._bwd_state[(dev, 1)] = K1.BackwardState(9, 1, (0, 32))
    a = K1.backward_scratch(dev, 1, 100, 1000, SMS)
    assert all(int(a[k].count_nonzero()) == 0 for k in K1.BWD_ZEROED)
    b = K1.backward_scratch(dev, 1, 100, 1000, SMS)
    assert all(a[k].data_ptr() == b[k].data_ptr() for k in a)
    c = K1.backward_scratch(dev, 1, 300, 1000, SMS)
    assert c["bitmap"].data_ptr() == a["bitmap"].data_ptr()
    assert c["list"].numel() == 300 and c["runs"].numel() == 1200
    assert c["keys"].numel() == 1024 and c["keys"].data_ptr() != a["keys"].data_ptr()
    d = K1.backward_scratch(dev, 1, 301, 1000, SMS)
    assert d["list"].numel() == 600  # twice the kept size
    other = K1.backward_scratch(dev, 2, 100, 1000, SMS)
    assert other["list"].data_ptr() != d["list"].data_ptr()
    assert set(K1._bwd_scratch) == {(dev, 1), (dev, 2)}
    # made anew with the bitmap: clean halves, the launch numbers go on
    assert K1._bwd_state[(dev, 1)] == K1.BackwardState(9)
    K1._bwd_state[(dev, 1)] = K1.BackwardState(9, 1, (0, 32))
    K1.backward_scratch(dev, 1, 100, 1000, SMS)  # kept: so is its state
    assert K1._bwd_state[(dev, 1)] == K1.BackwardState(9, 1, (0, 32))
    K1.backward_scratch(dev, 1, 100, 10_000, SMS)  # a larger table: a new, clean bitmap
    assert K1._bwd_state[(dev, 1)] == K1.BackwardState(9)


def test_backward_constants_match_the_source():
    """The sort cap, window and counters the wrapper and the model plan with
    are the kernel's own (``kSortCap``, ``kWindow``, ``kCounters`` lines of
    ``kCounterStride``); K2''s threads and rows a thread are instantiated."""
    src = (build.CSRC / "embedding_bag.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kSortCap"]) == K1.BWD_SORT_CAP
    assert "constexpr int kWindow = 32 * kSortCap;" in src
    assert K1.BWD_WINDOW == 32 * K1.BWD_SORT_CAP
    enum = re.search(r"enum \{ ([^}]*) \};", src).group(1).split(", ")
    assert enum[-1] == "kCounters"
    assert (len(enum) - 1) * int(const["kCounterStride"]) == K1.BWD_COUNTERS
    src2 = (build.CSRC / "dot_interaction.cu").read_text()
    assert K2.BWD_THREADS <= int(re.search(r"kBwdMaxThreads = (\d+)", src2).group(1))
    cases = set(re.findall(r"K2B_CASE\((\d), (\d)\)", src2))
    assert {(v, str(K2.BWD_ROWS_PER_THREAD)) for v in "14"} <= cases


# ----------------------------------------------------------- K1' model


def _bits_equal(got: np.ndarray, want: np.ndarray) -> None:
    """Bit-equal f32 arrays, signed zeros included; NaN where the other has
    NaN (the card's NaN has another payload than the CPU's)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def k1b_model(g, idx, w, V, masked, rng, state):
    """K1''s phases on the host (see the module docstring), with the
    bitmap's two halves kept in ``state`` ({"bitmap": [2, words] uint32,
    "halves": BackwardState}) from launch to launch.  Returns the gradient
    and the scratch the kernel leaves at zero (keys, counts)."""
    N = idx.size
    nnz = N // g.shape[0] if N else 0
    bits = K1.backward_table_bits(N)
    mask, shift = (1 << bits) - 1, 32 - bits
    halves = state["halves"]
    bitmap = state["bitmap"][halves.parity]
    assert not bitmap.any(), "the half a launch marks must be clean"
    keys = np.zeros(1 << bits, np.uint32)
    counts = np.zeros(1 << bits, np.int64)
    live = ~(masked & (w == 0)) if masked else np.ones(N, bool)
    rows = np.clip(idx.astype(np.int64), 0, V - 1)
    for s in np.flatnonzero(live):  # marks
        bitmap[rows[s] >> 5] |= np.uint32(1 << (rows[s] & 31))
    slot_entry, elist = np.full(N, -1), []
    for s in rng.permutation(N):  # 1: inserts, in any order
        if not live[s]:
            continue
        key = rows[s] + 1
        h = ((int(rows[s]) * 2654435769) & 0xFFFFFFFF) >> shift
        while keys[h] not in (0, key):
            h = (h + 1) & mask
        keys[h] = key
        if counts[h] == 0:
            elist.append(h)
        counts[h] += 1
        slot_entry[s] = h
    ebase, runs, total = {}, [], 0
    for k in rng.permutation(len(elist)):  # 2: run starts, in any order
        e = elist[k]
        ebase[e] = total
        runs.append((total, int(counts[e]), int(keys[e]) - 1))
        keys[e] = 0
        total += int(counts[e])
    lst = np.full(total, -1)
    for s in rng.permutation(N):  # 3: placement, in any order
        e = slot_entry[s]
        if e >= 0:
            counts[e] -= 1
            lst[ebase[e] + counts[e]] = s
    grad = np.full((V, g.shape[1]), np.nan, np.float32)  # torch.empty: anything
    written = np.zeros(V, int)
    window = K1.BWD_WINDOW
    for start, length, row in runs:  # 4: each run in slot order
        run = lst[start:start + length]
        acc = np.zeros(g.shape[1], np.float32)
        if length <= K1.BWD_SORT_CAP:  # by rank: the slots of the run below each
            ordered = np.empty_like(run)
            ordered[(run[None, :] < run[:, None]).sum(axis=1)] = run
            for s in ordered:
                acc = acc + w[s] * g[s // nnz]
            grad[row] = acc
            written[row] += 1
            continue
        lo = int(run.min())
        while lo is not None:
            words = np.zeros(window // 32, np.uint32)
            for s in run[(run >= lo) & (run < lo + window)]:
                words[(s - lo) >> 5] |= np.uint32(1 << ((s - lo) & 31))
            for wi, word in enumerate(words.tolist()):
                while word:
                    s = lo + wi * 32 + (word & -word).bit_length() - 1
                    word &= word - 1
                    acc = acc + w[s] * g[s // nnz]  # f32: the product rounded, then the sum
            beyond = run[run >= lo + window]
            lo = int(beyond.min()) if beyond.size else None
        grad[row] = acc
        written[row] += 1
    touched = np.unpackbits(bitmap.view(np.uint8), bitorder="little")[:V].astype(bool)
    grad[~touched] = 0.0  # the fill
    written[~touched] += 1
    state["bitmap"][1 - halves.parity][:halves.stale_words()] = 0  # the last launch's marks
    state["halves"] = halves.after(-(-V // 32))
    assert (written == 1).all(), "a row written twice or not at all"
    return grad, (keys, counts)


def _jax_vjp(g, idx, w, V, masked, D):
    """The table's gradient by XLA's autodiff of the reference lookup: K1's
    Pallas contract (``jref.embedding_bag_ref``) with ids clamped, or the
    masked gather ``where(w != 0, w * row, 0)`` of ``DisaggEmbedding``."""
    bags = g.shape[0]
    ids = jnp.asarray(np.clip(idx, 0, V - 1))
    wj = jnp.asarray(w)
    if masked:
        def look(t):
            rows = jnp.take(t, jnp.where(wj != 0, ids, 0), axis=0) * wj[:, None]
            rows = jnp.where((wj != 0)[:, None], rows, 0.0)
            return rows.reshape(bags, -1, D).sum(axis=1)
    else:
        def look(t):
            return jref.embedding_bag_ref(t, ids, wj, bags)
    _, vjp = jax.vjp(look, jnp.zeros((V, D), jnp.float32))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _case(name):
    """(grad_out, ids, weights, V, masked) of one adversarial case."""
    rng = np.random.default_rng(sum(name.encode()))
    spec = {  # bags, nnz, D, V, masked, ids, live fraction
        "one_row_every_slot": (3000, 3, 16, 50, True, "one", 1.0),
        "one_row_every_slot_weighted": (700, 4, 17, 9, False, "one", 1.0),
        "all_masked": (64, 4, 16, 40, True, "any", 0.0),
        "ids_out_of_range": (300, 4, 16, 60, True, "wide", 0.6),
        "ids_out_of_range_weighted": (300, 3, 17, 60, False, "wide", 0.6),
        "V_1": (90, 4, 8, 1, True, "wide", 0.7),
        "nnz_1": (400, 1, 64, 100, True, "any", 0.6),
        "nnz_3": (400, 3, 17, 100, False, "any", 0.6),
        "nnz_4": (1200, 4, 64, 8, True, "any", 0.6),  # runs past the sort cap, 2 windows
        "runs_by_rank": (1200, 4, 64, 40, True, "any", 0.6),  # runs of 33-128 slots
    }[name]
    bags, nnz, D, V, masked, ids, live = spec
    N = bags * nnz
    if ids == "one":
        idx = np.full(N, 7 % V, np.int32)
    elif ids == "wide":
        idx = rng.integers(-50, V + 50, N).astype(np.int32)
    else:
        idx = rng.integers(0, V, N).astype(np.int32)
    w = (rng.random(N) + 0.5).astype(np.float32)
    w[rng.random(N) >= live] = 0.0
    g = rng.normal(size=(bags, D)).astype(np.float32)
    if masked:  # the gradient of a bag of padding alone must reach no row
        g[(w.reshape(bags, nnz) == 0).all(axis=1)] = np.nan
    return g, idx, w, V, masked


K1B_CASES = ["one_row_every_slot", "one_row_every_slot_weighted", "all_masked",
             "ids_out_of_range", "ids_out_of_range_weighted", "V_1", "nnz_1", "nnz_3",
             "nnz_4", "runs_by_rank"]


@pytest.mark.parametrize("name", K1B_CASES)
def test_k1b_model_is_the_plain_version_bit_for_bit(name):
    """Whatever order the atomics give the runs and their slots, the model
    of K1' equals the plain version on the CPU bit for bit, writes every
    row once and leaves its scratch at zero; it agrees with jax.vjp of the
    reference's lookup at f32's tolerance."""
    g, idx, w, V, masked = _case(name)
    want = ref.embedding_bag_backward_ref(torch.from_numpy(g), torch.from_numpy(idx),
                                          torch.from_numpy(w), V, masked=masked).numpy()
    state = {"bitmap": np.zeros((2, -(-V // 32)), np.uint32), "halves": K1.BackwardState()}
    for seed in (0, 1, 2):  # three launches: each half marked, then cleared
        got, scratch = k1b_model(g, idx, w, V, masked, np.random.default_rng(seed), state)
        _bits_equal(got, want)
        assert all(not part.any() for part in scratch)
    if masked:
        assert np.isfinite(got).all()
    if name == "all_masked":
        assert not got.any()
    np.testing.assert_allclose(got, _jax_vjp(g, idx, w, V, masked, g.shape[1]),
                               rtol=RTOL, atol=ATOL)


def test_k1b_cases_reach_both_orders():
    """The hot row's run spans more than two windows; ``nnz_4``'s runs pass
    the sort cap, ``runs_by_rank``'s lie between a warp and the cap."""
    g, idx, w, V, masked = _case("one_row_every_slot")
    live = np.flatnonzero(w != 0)
    assert live.max() - live.min() > 2 * K1.BWD_WINDOW
    for name, lo, hi in (("nnz_4", K1.BWD_SORT_CAP + 1, None), ("runs_by_rank", 33, 128)):
        g, idx, w, V, masked = _case(name)
        runs = np.bincount(np.clip(idx, 0, V - 1)[w != 0], minlength=V)
        assert runs.max() >= lo and (hi is None or runs.max() <= hi)


# ------------------------------------------------ K1' wrapper, library faked


class _FakeLib:
    """Records each call of a library function and answers the occupancy
    query with ``occupancy`` blocks an SM."""

    _name = "libfake.so"

    def __init__(self, occupancy=4):
        self.calls, self.occ = [], occupancy

    def __getattr__(self, sym):
        if "occupancy" in sym:
            return lambda *a: self.calls.append((sym, a)) or self.occ
        return lambda *a: self.calls.append((sym, a)) or 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA branches of the K1' and K2' wrappers on CPU tensors: the
    libraries, device, stream and SM count faked; scratch on the CPU."""
    libs = {K1.NAME: _FakeLib(), K2.NAME: _FakeLib()}
    monkeypatch.setattr(K1, "_on_cuda", lambda t: True)
    monkeypatch.setattr(K2, "_on_cuda", lambda t: True)
    monkeypatch.setattr(K1, "_occupancy", {})
    monkeypatch.setattr(K1, "_bwd_scratch", {})
    monkeypatch.setattr(K1, "_bwd_state", {})
    monkeypatch.setattr(K1, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(build, "load", lambda name, sigs: libs[name])
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=77))
    before = (K1.launches_backward, K2.launches_backward)
    yield libs
    K1.launches_backward, K2.launches_backward = before


def test_k1b_launch_arguments_and_kept_scratch(fake_cuda, monkeypatch):
    """One cooperative launch of one wave (SMs x the occupancy, at most
    BWD_BLOCKS_PER_SM), the plan's table bits and the scratch kept for
    (device, stream); from the second call on, no fill, no sort, no
    allocation but the output."""
    lib, start = fake_cuda[K1.NAME], K1.launches_backward
    g, idx, w = torch.zeros(256 * 26, 64), torch.zeros(26624, dtype=torch.int32), torch.ones(26624)
    K1.embedding_bag_backward(g, idx, w, 1_272_000, masked=True)
    calls = []
    for name in ("zeros", "sort", "empty", "zeros_like", "full"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    out = K1.embedding_bag_backward(g, idx, w, 1_272_000, masked=True)
    assert calls == ["empty"] and out.shape == (1_272_000, 64)
    (occ_sym, occ_args), (sym, a1), (_, a2) = lib.calls
    assert (occ_sym, occ_args) == (K1.BWD_OCC_SYMBOL, (4,))
    assert sym == K1.BWD_SYMBOL
    # n, nnz, dim, num_rows, masked, vec, blocks ... table_bits, stream
    assert a1[4:11] == (26624, 4, 64, 1_272_000, 1, 4, K1.BWD_BLOCKS_PER_SM * SMS)
    assert a1[-2:] == (16, 77)
    key = (torch.device("cpu"), 77)
    sc = K1._bwd_scratch[key]
    order = ("keys", "counts", "ebase", "elist", "runs", "slot_entry", "list")
    assert a1[11:13] == a2[11:13] == (sc["counters"].data_ptr(), sc["flags"].data_ptr())
    assert sc["flags"].numel() == 32 * K1.BWD_BLOCKS_PER_SM * SMS
    assert a1[17:24] == a2[17:24] == tuple(sc[k].data_ptr() for k in order)
    # launch numbers 1 and 2; the bitmap's halves marked, then cleared by the next launch
    lo, hi = sc["bitmap"].data_ptr(), sc["bitmap"].data_ptr() + 4 * 39_750
    assert a1[13:17] == (1, lo, hi, 0) and a2[13:17] == (2, hi, lo, 39_750)
    assert K1._bwd_state[key] == K1.BackwardState(3, 0, (0, 39_750))
    assert K1.launches_backward == start + 2


def test_k1b_launch_vec_and_empty_batch(fake_cuda):
    """D = 17 takes 4-byte vectors; a batch of nnz 0 still launches (the
    kernel writes every row's zeros)."""
    lib = fake_cuda[K1.NAME]
    K1.embedding_bag_backward(torch.zeros(5, 17), torch.zeros(15, dtype=torch.int32),
                              torch.ones(15), 9)
    K1.embedding_bag_backward(torch.zeros(5, 16), torch.zeros(0, dtype=torch.int32),
                              torch.ones(0), 9)
    launches = [a for s, a in lib.calls if s == K1.BWD_SYMBOL]
    assert [a[4:10] for a in launches] == [(15, 3, 17, 9, 0, 1), (0, 0, 16, 9, 0, 4)]
    assert [a[-2] for a in launches] == [5, 1]


@pytest.mark.parametrize("args,exc,match", [
    ((torch.zeros(2, 8, dtype=torch.float64), torch.zeros(4, dtype=torch.int32),
      torch.ones(4), 10), TypeError, "grad_out must be"),
    ((torch.zeros(8), torch.zeros(4, dtype=torch.int32), torch.ones(4), 10),
     TypeError, "grad_out must be"),
    ((torch.zeros(2, 8), torch.zeros(4, dtype=torch.int64), torch.ones(4), 10),
     TypeError, "int32"),
    ((torch.zeros(2, 8), torch.zeros(4, dtype=torch.int32), torch.ones(3), 10),
     TypeError, "int32"),
    ((torch.zeros(8, 2).t(), torch.zeros(4, dtype=torch.int32), torch.ones(4), 10),
     ValueError, "contiguous"),
    ((torch.zeros(3, 8), torch.zeros(4, dtype=torch.int32), torch.ones(4), 10),
     ValueError, "fixed-nnz"),
    ((torch.zeros(2, 8), torch.zeros(4, dtype=torch.int32), torch.ones(4), 0),
     ValueError, "rows outside"),
    ((torch.zeros(2, 8), torch.zeros(4, dtype=torch.int32), torch.ones(4), 2**31 - 1),
     ValueError, "rows outside"),
], ids=["f64", "rank", "int64-ids", "weights-shape", "strided", "nnz", "no-rows",
        "too-many-rows"])
def test_k1b_refuses_bad_input(fake_cuda, args, exc, match):
    with pytest.raises(exc, match=match):
        K1.embedding_bag_backward(*args)
    assert not fake_cuda[K1.NAME].calls


def test_k1b_refuses_too_many_slots(fake_cuda, monkeypatch):
    monkeypatch.setattr(K1, "MAX_SLOTS", 6)
    with pytest.raises(ValueError, match="slots over 6"):
        K1.embedding_bag_backward(torch.zeros(2, 8), torch.zeros(8, dtype=torch.int32),
                                  torch.ones(8), 10)


# ------------------------------------------------------------- K2' plan


@pytest.mark.parametrize("B,F,D", [(256, 27, 64), (32, 17, 64), (1024, 17, 64), (4, 27, 17),
                                   (3, 40, 512), (2, 5, 8)])
def test_k2b_plan_covers_every_row(B, F, D):
    """A block is at most kBwdMaxThreads threads, its column threads a
    power of two spanning the row's vectors (at most 32), and a sample's
    blocks cover its F rows; at the trainer's [256, 27, 64] the grid holds
    more than four blocks an SM."""
    plan = K2.backward_plan(F, D, aligned=True)
    assert plan.vec == (4 if D % 4 == 0 else 1)
    nv = D // plan.vec
    assert plan.col_threads & (plan.col_threads - 1) == 0
    assert min(nv, 32) <= plan.col_threads <= 32 and plan.col_threads * plan.row_threads <= 128
    rows = plan.row_threads * plan.rows_per_thread
    assert plan.row_blocks * rows >= F > (plan.row_blocks - 1) * rows
    if (B, F, D) == (256, 27, 64):
        assert plan == K2.BackwardPlan(4, 16, 4, 2, 4) and B * plan.row_blocks >= 4 * SMS
    assert K2.backward_plan(F, D, aligned=False).vec == 1


def k2b_model(x, tri, plan):
    """K2''s blocks and threads on the host: S read from the triangle at the
    kernel's offsets, each output summed over j ascending in f32.  Returns
    dx and how many times each output was written."""
    B, F, D = x.shape
    dx = np.full(x.shape, np.nan, np.float32)
    writes = np.zeros(x.shape, int)
    off = [i * F - i * (i - 1) // 2 for i in range(F)]
    nv, vec = D // plan.vec, plan.vec
    for b in range(B):
        for rb in range(plan.row_blocks):
            for t in range(plan.col_threads * plan.row_threads):
                ct, rt = t % plan.col_threads, t // plan.col_threads
                for k in range(plan.rows_per_thread):
                    i = (rb * plan.rows_per_thread + k) * plan.row_threads + rt
                    if i >= F:
                        continue
                    cols = [c * vec + v for c in range(ct, nv, plan.col_threads)
                            for v in range(vec)]
                    acc = np.zeros(len(cols), np.float32)
                    offj = 0
                    for j in range(F):
                        s = tri[b, offj + i - j] if j < i else tri[b, off[i] + j - i]
                        if j == i:
                            s = s + s
                        acc = acc + s * x[b, j, cols]
                        offj += F - j
                    dx[b, i, cols] = acc
                    writes[b, i, cols] += 1
    return dx, writes


@pytest.mark.parametrize("B,F,D,aligned", [(3, 27, 64, True), (2, 17, 64, True),
                                           (2, 7, 17, True), (2, 6, 8, False)])
def test_k2b_model_matches_the_plain_version(B, F, D, aligned):
    """The kernel's indexing reads S = G + G^T exactly and writes every
    output once; its sums agree with the plain version at 1e-5."""
    rng = np.random.default_rng(F * D)
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    tri = rng.normal(size=(B, F * (F + 1) // 2)).astype(np.float32)
    got, writes = k2b_model(x, tri, K2.backward_plan(F, D, aligned))
    assert (writes == 1).all()
    want = ref.dot_interaction_backward_ref(torch.from_numpy(x), torch.from_numpy(tri))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


def test_k2b_launch_arguments(fake_cuda):
    lib = fake_cuda[K2.NAME]
    K2.dot_interaction_backward(torch.zeros(256, 27, 64), torch.zeros(256, 378))
    (sym, a), = lib.calls
    # batch, F, D, vec, rows_per_thread, col_threads, row_threads, row_blocks, stream
    assert sym == K2.BWD_SYMBOL and a[3:] == (256, 27, 64, 4, 2, 16, 4, 4, 77)


@pytest.mark.parametrize("x,g,exc,match", [
    (torch.zeros(2, 3, 8, dtype=torch.float64), torch.zeros(2, 6), TypeError, "f32"),
    (torch.zeros(2, 3, 8), torch.zeros(2, 6, dtype=torch.bfloat16), TypeError, "f32"),
    (torch.zeros(6, 8), torch.zeros(2, 6), ValueError, "want a contiguous"),
    (torch.zeros(2, 8, 3).transpose(1, 2), torch.zeros(2, 6), ValueError, "want a contiguous"),
    (torch.zeros(2, 3, 8), torch.zeros(2, 5), ValueError, "grad_tri"),
    (torch.zeros(2, 3, 8), torch.zeros(6, 2).t(), ValueError, "grad_tri"),
    (torch.zeros(1, 100, 600), torch.zeros(1, 5050), ValueError, "shared memory"),
    (torch.zeros(2, 3, 8), torch.zeros(2, 6), ValueError, "CUDA"),
], ids=["f64", "bf16-grad", "rank", "strided", "tri-shape", "tri-strided", "too-large", "cpu"])
def test_k2b_refuses_bad_input(x, g, exc, match):
    """Every argument the kernel cannot take raises before any launch; a
    good CPU tensor is refused last, as not on the card."""
    before = K2.launches_backward
    with pytest.raises(exc, match=match):
        K2.dot_interaction_backward(x, g)
    assert K2.launches_backward == before


@pytest.mark.parametrize("F,D,want", [(27, 64, 8424), (17, 64, 4964), (40, 512, 85200)])
def test_k2b_smem(F, D, want):
    """The sample's rows and its triangle's gradient, f32."""
    assert K2.backward_smem_bytes(F, D) == want <= K2.MAX_SMEM
