"""The backward kernels K1' (``embedding_bag_backward``) and K2'
(``dot_interaction_backward``) without the card: their host-side plans,
numpy models of what their kernels do, their wrappers' launches (the
library faked) and refusals, on the CPU.

K1''s model runs the kernel's phases on the host: marks in a bitmap of the
rows; each touched row's rank among the touched rows from the marks below
it, counted in chunks of bitmap words a grouping warp; each live slot's
row's rank and its place in the row's run in a random order (the atomics
decide it); each run's start from chunks of ranks taken in a random order,
a long index and buckets for each run past ``BWD_SORT_CAP``; each slot at
its place; a long run's slots into buckets by their high bits, in a random
order within a bucket, each bucket then ordered by rank (up to
``BWD_SORT_CAP`` slots) or through bitmap windows of ``BWD_WINDOW`` slots;
then each short run ordered by rank and summed a row at a time, each long
run summed a column vector at a time, every run in slot order (w *
grad_out rounded, then added, in f32), and zeros into every row no live
slot names.  It must equal ``ref.embedding_bag_backward_ref`` on the CPU
bit for bit (that plain version adds in slot order too), whatever the
random orders, write every row once, leave its counts and buckets at zero
and start each launch on a clean half of the bitmap.  Against ``jax.vjp``
of the reference's lookup (ids clamped, the masked gather's ``where``):
rtol 1e-5, atol 1e-6 (f32, XLA's scatter-add order).

K2''s model walks the plan's blocks and threads and reads S = G + G^T from
the triangle as the kernel indexes it: every output written once, S
exactly G + G^T, and the result within 1e-5 of the plain version (f32 sums
in the kernel's order, without its FMA).
"""
import contextlib
import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.data import synthetic as syn
from repro_torch.kernels import build, ref
from repro_torch.kernels import dot_interaction as K2
from repro_torch.kernels import embedding_bag as K1

RTOL, ATOL = 1e-5, 1e-6
SMS = 132  # an H100's SMs, as the fake device reports them


# ------------------------------------------------------------- K1' plan


def _ranks(bitmap: np.ndarray, V: int, G: int) -> tuple[np.ndarray, np.ndarray]:
    """Phase 0 as the kernel runs it on ``G`` grouping warps: each warp's
    chunk of ceil(words / G) bitmap words counted, then each word's rank
    (the marks below it: the warp's base from the chunks below, a running
    sum within) and each rank's row, lane by lane, bit by bit."""
    words = bitmap.size
    cw = -(-words // G)
    chunks = [int(np.unpackbits(bitmap[w * cw:(w + 1) * cw].view(np.uint8)).sum())
              for w in range(G)]
    wprefix, rowof = np.zeros(words, np.int64), []
    for w in range(G):
        d = sum(chunks[:w])
        for i in range(w * cw, min(words, (w + 1) * cw)):
            wprefix[i] = d
            word = int(bitmap[i])
            while word:
                rowof.append(i * 32 + (word & -word).bit_length() - 1)
                word &= word - 1
                d += 1
    return wprefix, np.array(rowof, np.int64)


@pytest.mark.parametrize("V,G,fill", [(1, 4, 1.0), (33, 1, 0.5), (1000, 264, 0.1),
                                      (1000, 3, 0.0), (4096, 7, 0.3), (100_000, 528, 0.01),
                                      (100_000, 5, 0.9), (70, 528, 1.0)])
def test_backward_ranks_are_the_touched_rows_in_order(V, G, fill):
    """A touched row's rank (its word's rank plus the marks below it in the
    word) is its index among the touched rows in row order, whatever the
    grid's grouping warps (more warps than words too), and each rank's row
    is that row: the kernel's dense index of a row, in place of a table."""
    rng = np.random.default_rng(V + G)
    touched = np.flatnonzero(rng.random(V) < fill)
    bitmap = np.zeros(-(-V // 32), np.uint32)
    for r in touched:
        bitmap[r >> 5] |= np.uint32(1 << (r & 31))
    wprefix, rowof = _ranks(bitmap, V, G)
    np.testing.assert_array_equal(rowof, touched)
    for d, r in enumerate(touched):
        below = int(bitmap[r >> 5]) & ((1 << (r & 31)) - 1)
        assert wprefix[r >> 5] + bin(below).count("1") == d


@pytest.mark.parametrize("n,V", [(26624, 1_272_000), (26624, 16_777_216), (0, 1), (7, 33),
                                 (20_971_520, 25_600_000)])
def test_backward_scratch_sizes(n, V):
    """A flag line a block, two halves of a bit a row, a word a grouping
    warp and a word a bitmap word for the ranks, n entries for the rest
    (two words a run start, four a run and a long run), and the buckets'
    cap; at 16,777,216 rows a half is 2 MB (2^19 words)."""
    sizes = K1.backward_scratch_sizes(n, V, 8 * SMS)
    m, words = max(1, n), -(-V // 32)
    buckets = n // 16 + 2 * (n // 129) + 1
    assert sizes == {"counters": K1.BWD_COUNTERS, "flags": 32 * 8 * SMS,
                     "bitmap": 2 * words, "wchunk": 2 * 8 * SMS, "wprefix": words,
                     "counts": m, "ebase": 2 * m, "runs": 4 * m, "rowof": m,
                     "slot_entry": m,
                     "slot_rank": m, "list": m, "longs": 4 * max(1, n // 129),
                     "buckets": buckets, "brun": buckets, "order": m}
    if V == 16_777_216:
        assert sizes["bitmap"] == 2 << 19


@pytest.mark.parametrize("n,lengths", [
    (129, [129]), (20_971_520, [20_971_520]), (20_971_520, [129] * (20_971_520 // 129)),
    (20_971_520, [160] * (20_971_520 // 160)), (4800, [129, 130, 200, 4000 - 459]),
    (1 << 30, [129] * ((1 << 30) // 129)), (1 << 30, [(1 << 30) - 129 * 5] + [129] * 5)])
def test_backward_bucket_cap_holds_every_split(n, lengths):
    """However the live slots split into long runs, their buckets fit
    ``backward_bucket_cap`` and their count ``backward_long_cap``; each run
    has fewer buckets than L / 16 + 2 and at least one a tile, and its
    buckets cut the slots [0, 2^slot_bits) into equal powers of two."""
    assert sum(lengths) <= n and min(lengths) > K1.BWD_SORT_CAP
    assert len(lengths) <= K1.backward_long_cap(n)
    nbs = {L: 1 << K1.backward_bucket_bits(L) for L in set(lengths)}
    assert sum(nbs[L] for L in lengths) <= K1.backward_bucket_cap(n)
    slot_bits = (n - 1).bit_length()
    for L, nb in nbs.items():
        assert -(-L // K1.BWD_BUCKET_AIM) <= nb < L / 16 + 2
        assert nb >= -(-L // K1.BWD_TILE) and nb <= 1 << slot_bits


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
    assert c["counts"].numel() == 300 and c["counts"].data_ptr() != a["counts"].data_ptr()
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
    """The sort cap, window, bucket aim, tile, hot-run length, grouping
    warps, bucket cap and counters the wrapper and the model plan with are
    the kernel's own
    (``kSortCap``, ``kWindow``, ``kBucketAim``, ``kTile``, ``kHotRun``,
    ``kGroupWarps``, ``kCounters`` lines of ``kCounterStride``); K2''s
    threads and rows a thread are instantiated."""
    src = (build.CSRC / "embedding_bag.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kSortCap"]) == K1.BWD_SORT_CAP
    assert "constexpr int kWindow = 32 * kSortCap;" in src
    assert K1.BWD_WINDOW == 32 * K1.BWD_SORT_CAP
    assert int(const["kBucketAim"]) == K1.BWD_BUCKET_AIM
    assert int(const["kTile"]) == K1.BWD_TILE
    assert int(const["kHotRun"]) == K1.BWD_HOT_RUN
    assert int(const["kGroupWarps"]) == K1.BWD_GROUP_WARPS
    # the bucket cap the library checks is the wrapper's
    assert "bucket_cap < n / 16 + 2 * (n / (kSortCap + 1)) + 1" in src
    enum = re.findall(r"k\w+", re.search(r"enum \{([^}]*)\};", src).group(1))
    assert enum[-1] == "kCounters"
    assert (len(enum) - 1) * int(const["kCounterStride"]) == K1.BWD_COUNTERS
    src2 = (build.CSRC / "dot_interaction.cu").read_text()
    assert K2.BWD_THREADS <= int(re.search(r"kBwdMaxThreads = (\d+)", src2).group(1))
    cases = set(re.findall(r"K2B_CASE\((\d), (\d)\)", src2))
    assert {(v, str(K2.BWD_ROWS_PER_THREAD)) for v in "14"} <= cases


@pytest.mark.parametrize("spec", ["k1b_split", "k1b_hot", "turns_k1b"])
def test_k1b_variant_specs_match_the_source(spec):
    """Every text a K1' design variant of ``tools/kernel_variants.py``
    substitutes is in the committed source (the tool raises otherwise), and
    its hot-row cases name recsys archs of phase 5g."""
    src = (build.CSRC / "embedding_bag.cu").read_text()
    path = build.CSRC.parents[2] / "tools" / "kernel_variants" / f"{spec}.json"
    data = json.loads(path.read_text())
    assert data["kernel"] == "embedding_bag"
    for variant in data["variants"]:
        for old, _ in variant.get("subs", []):
            assert old in src, (variant["name"], old)
    for case in data["cases"]:
        assert case[0] == "backward"
        if isinstance(case[1], str):
            assert case[1] in ("wide-deep", "two-tower-retrieval", "autoint", "dcn-v2", "deepfm")


# ----------------------------------------------------------- K1' model


def _bits_equal(got: np.ndarray, want: np.ndarray) -> None:
    """Bit-equal f32 arrays, signed zeros included; NaN where the other has
    NaN (the card's NaN has another payload than the CPU's)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _by_windows(src: np.ndarray) -> list:
    """``order_by_windows``: a bucket past the sort cap in ascending order
    through bitmap windows of ``BWD_WINDOW`` slots from the least slot not
    yet placed, each window a rescan of the bucket."""
    out, lo = [], int(src.min())
    while lo is not None:
        words = np.zeros(K1.BWD_WINDOW // 32, np.uint32)
        for s in src[(src >= lo) & (src < lo + K1.BWD_WINDOW)]:
            words[(s - lo) >> 5] |= np.uint32(1 << ((s - lo) & 31))
        for wi, word in enumerate(words.tolist()):
            while word:
                out.append(lo + wi * 32 + (word & -word).bit_length() - 1)
                word &= word - 1
        beyond = src[src >= lo + K1.BWD_WINDOW]
        lo = int(beyond.min()) if beyond.size else None
    return out


def _by_rank(src: np.ndarray) -> np.ndarray:
    """``order_by_rank``: dst[rank] = slot, a slot's rank the slots below it."""
    dst = np.empty_like(src)
    dst[(src[None, :] < src[:, None]).sum(axis=1)] = src
    return dst


def k1b_model(g, idx, w, V, masked, rng, state, paths=None, G=7):
    """K1''s phases on the host (see the module docstring) on ``G`` grouping
    warps, with the bitmap's two halves kept in ``state`` ({"bitmap": [2,
    words] uint32, "halves": BackwardState}) from launch to launch;
    ``paths`` (a dict) counts the ways each run and bucket was ordered.
    Returns the gradient and the scratch the kernel leaves at zero (the
    counts, the buckets)."""
    N = idx.size
    nnz = N // g.shape[0] if N else 0
    D = g.shape[1]
    vec = 4 if D % 4 == 0 else 1
    slot_bits = (N - 1).bit_length() if N > 1 else 0
    halves = state["halves"]
    bitmap = state["bitmap"][halves.parity]
    assert not bitmap.any(), "the half a launch marks must be clean"
    buckets = np.zeros(K1.backward_bucket_cap(N), np.int64)
    long_cap = K1.backward_long_cap(N)
    paths = paths if paths is not None else {}
    live = ~(masked & (w == 0)) if masked else np.ones(N, bool)
    rows = np.clip(idx.astype(np.int64), 0, V - 1)
    for s in np.flatnonzero(live):  # marks
        bitmap[rows[s] >> 5] |= np.uint32(1 << (rows[s] & 31))
    wprefix, rowof = _ranks(bitmap, V, G)  # 0: ranks
    R = rowof.size
    counts = np.zeros(max(1, R), np.int64)
    rank, place = np.full(N, -1), np.zeros(N, np.int64)
    for s in rng.permutation(np.flatnonzero(live)):  # 1: ranks and places, in any order
        r = rows[s]
        below = int(bitmap[r >> 5]) & ((1 << int(r & 31)) - 1)
        rank[s] = wprefix[r >> 5] + bin(below).count("1")
        place[s] = counts[rank[s]]
        counts[rank[s]] += 1
    # 2: a warp a chunk of ranks, the chunks in any order: each run's start,
    # and a long index (hot ones from 0 up, the rest from long_cap - 1
    # down) and buckets for each run past the sort cap
    runs, longs, total, nbuckets, hot, cool = [None] * R, {}, 0, 0, 0, 0
    cr = -(-R // G)
    for wc in rng.permutation(G):
        for k in range(wc * cr, min(R, (wc + 1) * cr)):
            length, row, j = int(counts[k]), int(rowof[k]), -1
            if length > K1.BWD_SORT_CAP:
                if length >= K1.BWD_HOT_RUN:
                    j, hot = hot, hot + 1
                else:
                    j, cool = long_cap - 1 - cool, cool + 1
                longs[j] = (total, length, row, nbuckets)
                nbuckets += 1 << K1.backward_bucket_bits(length)
            runs[k] = (total, length, row, j)
            counts[k] = 0
            total += length
    assert nbuckets <= buckets.size and hot + cool <= long_cap
    lst = np.full(total, -1)
    for s in rng.permutation(N):  # 3: placement and the buckets' counts, in any order
        if rank[s] >= 0:
            start, _, _, j = runs[rank[s]]
            lst[start + place[s]] = s
            if j >= 0:
                _, length, _, first = longs[j]
                buckets[first + (s >> (slot_bits - K1.backward_bucket_bits(length)))] += 1
    order = np.full(total, -1)
    for j, (start, length, row, first) in longs.items():
        nb = 1 << K1.backward_bucket_bits(length)
        cnt = buckets[first:first + nb].copy()
        buckets[first:first + nb] = np.cumsum(cnt) - cnt  # 3b: counts into starts
        bshift = slot_bits - K1.backward_bucket_bits(length)
        for s in rng.permutation(lst[start:start + length]):  # 3c: into buckets, any order
            b = first + (s >> bshift)
            order[start + buckets[b]] = s
            buckets[b] += 1
        for b in range(nb):  # 3d: each bucket ordered on its own, back into the list
            lo = 0 if b == 0 else buckets[first + b - 1]
            src = order[start + lo:start + buckets[first + b]]
            if src.size > K1.BWD_SORT_CAP:
                lst[start + lo:start + lo + src.size] = _by_windows(src)
                paths["windows"] = paths.get("windows", 0) + 1
            elif src.size:
                lst[start + lo:start + lo + src.size] = _by_rank(src)
                paths["bucket_rank"] = paths.get("bucket_rank", 0) + 1
        buckets[first:first + nb] = 0
    grad = np.full((V, D), np.nan, np.float32)  # torch.empty: anything
    written = np.zeros((V, D // vec), int)
    for start, length, row, j in runs:  # 4: each run in slot order
        run = lst[start:start + length]
        if j < 0:  # by rank, a whole row at a time
            paths["run_rank"] = paths.get("run_rank", 0) + 1
            acc = np.zeros(D, np.float32)
            for s in _by_rank(run):
                acc = acc + w[s] * g[s // nnz]  # f32: the product rounded, then the sum
            grad[row] = acc
            written[row] += 1
            continue
        paths["long" if length < K1.BWD_HOT_RUN else "hot"] = paths.get(
            "long" if length < K1.BWD_HOT_RUN else "hot", 0) + 1
        assert (np.diff(run) > 0).all(), "a long run is not in slot order"
        for c in range(D // vec):  # a warp a column vector, lanes over the slots
            cols = slice(c * vec, (c + 1) * vec)
            acc = np.zeros(vec, np.float32)
            for s in run:
                acc = acc + w[s] * g[s // nnz, cols]
            grad[row, cols] = acc
            written[row, c] += 1
    touched = np.unpackbits(bitmap.view(np.uint8), bitorder="little")[:V].astype(bool)
    grad[~touched] = 0.0  # the fill
    written[~touched] += 1
    state["bitmap"][1 - halves.parity][:halves.stale_words()] = 0  # the last launch's marks
    state["halves"] = halves.after(-(-V // 32))
    assert (written == 1).all(), "a row written twice or not at all"
    return grad, (counts, buckets)


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
        "nnz_4": (1200, 4, 64, 8, True, "any", 0.6),  # runs past the sort cap, in buckets
        "runs_by_rank": (1200, 4, 64, 40, True, "any", 0.6),  # runs of 33-128 slots
        # Zipf ids (alpha 1.05): the hottest runs span the batch; D 8 (two
        # column vectors) and D 256 (more than one chunk of 32 vectors)
        "zipf_d8": (1500, 8, 8, 20_000, True, "zipf", 0.6),
        "zipf_d256": (1200, 1, 256, 400, True, "zipf", 1.0),
        "sort_cap_edges": (1000, 4, 16, 500, True, "edges", 0.5),  # runs of 128 and 129
        "run_of_thousands": (4000, 3, 16, 3000, False, "thousands", 1.0),  # a hot run
        "clustered": (1200, 4, 8, 900, True, "clustered", 0.5),  # a bucket past the cap
        # a bucket past the cap that spans two windows (2^16 slots, mostly masked)
        "clustered_two_windows": (10_000, 4, 4, 5000, True, "clustered_wide", 0.05),
    }[name]
    bags, nnz, D, V, masked, ids, live = spec
    N = bags * nnz
    if ids == "one":
        idx = np.full(N, 7 % V, np.int32)
    elif ids == "wide":
        idx = rng.integers(-50, V + 50, N).astype(np.int32)
    elif ids == "zipf":
        idx = syn.zipf_indices(rng, V, N, 1.05).astype(np.int32)
    elif ids == "thousands":  # row 5 named by 5,000 slots across the batch
        idx = rng.integers(0, V, N).astype(np.int32)
        idx[rng.choice(N, 5000, replace=False)] = 5
    elif ids in ("edges", "clustered", "clustered_wide"):
        idx = rng.integers(4, V, N).astype(np.int32)
    else:
        idx = rng.integers(0, V, N).astype(np.int32)
    w = (rng.random(N) + 0.5).astype(np.float32)
    w[rng.random(N) >= live] = 0.0
    if ids == "edges":  # rows 1 and 2 named by exactly 128 and 129 live slots
        live_at = rng.permutation(np.flatnonzero(w != 0))
        idx[live_at[:128]], idx[live_at[128:257]] = 1, 2
    elif ids == "clustered":  # row 3: the first 300 slots, and 40 more across the batch
        at = np.concatenate([np.arange(300), rng.choice(np.arange(300, N), 40, replace=False)])
        idx[at], w[at] = 3, 1.0
    elif ids == "clustered_wide":  # row 3: 200 slots below 8,192, 40 more above
        at = np.concatenate([rng.choice(8192, 200, replace=False),
                             rng.choice(np.arange(8192, N), 40, replace=False)])
        idx[at], w[at] = 3, 1.0
    g = rng.normal(size=(bags, D)).astype(np.float32)
    if masked:  # the gradient of a bag of padding alone must reach no row
        g[(w.reshape(bags, nnz) == 0).all(axis=1)] = np.nan
    return g, idx, w, V, masked


K1B_CASES = ["one_row_every_slot", "one_row_every_slot_weighted", "all_masked",
             "ids_out_of_range", "ids_out_of_range_weighted", "V_1", "nnz_1", "nnz_3",
             "nnz_4", "runs_by_rank", "zipf_d8", "zipf_d256", "sort_cap_edges",
             "run_of_thousands", "clustered", "clustered_two_windows"]


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


def _runs(name: str) -> np.ndarray:
    """The live slots of each row of a case (clamped ids)."""
    g, idx, w, V, masked = _case(name)
    return np.bincount(np.clip(idx, 0, V - 1)[w != 0], minlength=V)


def test_k1b_cases_reach_both_orders():
    """Every way the kernel orders slots is reached: short runs by rank
    (``runs_by_rank``'s lie between a warp and the cap), long runs through
    buckets ordered by rank (``nnz_4``'s, the hot rows'), a bucket past the
    cap through one bitmap window (``clustered``) and through two
    (``clustered_two_windows``), runs of exactly ``BWD_SORT_CAP`` and one
    more, hot runs of thousands (past ``BWD_HOT_RUN``), and Zipf batches
    whose hottest run spans the slots, at D 8 and D 256."""
    g, idx, w, V, masked = _case("one_row_every_slot")
    live = np.flatnonzero(w != 0)
    assert live.max() - live.min() > 2 * K1.BWD_WINDOW and live.size >= K1.BWD_HOT_RUN
    assert _runs("nnz_4").min() > K1.BWD_SORT_CAP
    assert 33 <= _runs("runs_by_rank").max() <= K1.BWD_SORT_CAP
    assert sorted(_runs("sort_cap_edges"))[-2:] == [K1.BWD_SORT_CAP, K1.BWD_SORT_CAP + 1]
    assert _runs("run_of_thousands").max() >= K1.BWD_HOT_RUN
    for name, D in (("zipf_d8", 8), ("zipf_d256", 256)):
        g, idx, w, V, masked = _case(name)
        hot = np.flatnonzero((idx == np.bincount(idx[w != 0]).argmax()) & (w != 0))
        assert g.shape[1] == D and hot.size > K1.BWD_SORT_CAP
        assert hot.min() < idx.size // 20 and hot.max() > idx.size - idx.size // 20
    for name, windows in (("clustered", 1), ("clustered_two_windows", 2)):
        g, idx, w, V, masked = _case(name)
        at = np.flatnonzero((idx == 3) & (w != 0))
        state = {"bitmap": np.zeros((2, -(-V // 32)), np.uint32), "halves": K1.BackwardState()}
        paths = {}
        k1b_model(g, idx, w, V, masked, np.random.default_rng(0), state, paths)
        assert paths["windows"] == 1 and paths["bucket_rank"] >= 1
        width = 1 << ((idx.size - 1).bit_length() - K1.backward_bucket_bits(at.size))
        bucket, lo, seen = at[at < width], at.min(), 0  # the run's bucket 0
        assert bucket.size > K1.BWD_SORT_CAP
        while lo is not None:  # the windows of order_by_windows
            seen += 1
            beyond = bucket[bucket >= lo + K1.BWD_WINDOW]
            lo = beyond.min() if beyond.size else None
        assert seen == windows


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
    BWD_BLOCKS_PER_SM), the plan's caps of long runs and buckets and the
    scratch kept for (device, stream); from the second call on, no fill,
    no sort, no allocation but the output."""
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
    # n, nnz, dim, num_rows, masked, vec, blocks ... long_cap, bucket_cap, stream
    assert a1[4:11] == (26624, 4, 64, 1_272_000, 1, 4, K1.BWD_BLOCKS_PER_SM * SMS)
    assert a1[-3:] == (26624 // 129, 26624 // 16 + 2 * (26624 // 129) + 1, 77)
    key = (torch.device("cpu"), 77)
    sc = K1._bwd_scratch[key]
    order = ("wchunk", "wprefix", "counts", "ebase", "runs", "rowof", "slot_entry",
             "slot_rank", "list", "longs", "buckets", "brun", "order")
    assert K1.BWD_POINTERS == order and len(a1) == 33
    assert a1[11:13] == a2[11:13] == (sc["counters"].data_ptr(), sc["flags"].data_ptr())
    assert sc["flags"].numel() == 32 * K1.BWD_BLOCKS_PER_SM * SMS
    assert sc["wchunk"].numel() == K1.BWD_GROUP_WARPS * K1.BWD_BLOCKS_PER_SM * SMS
    assert a1[17:30] == a2[17:30] == tuple(sc[k].data_ptr() for k in order)
    # launch numbers 1 and 2; the bitmap's halves marked, then cleared by the next launch
    lo, hi = sc["bitmap"].data_ptr(), sc["bitmap"].data_ptr() + 4 * 39_750
    assert a1[13:17] == (1, lo, hi, 0) and a2[13:17] == (2, hi, lo, 39_750)
    assert K1._bwd_state[key] == K1.BackwardState(3, 0, (0, 39_750))
    assert K1.launches_backward == start + 2


def test_k1b_plan_kept_until_its_key_changes(fake_cuda, monkeypatch):
    """The launch plan (grid, scratch pointers, caps) is made once for a
    (device, stream) and kept while the library, vec, slots and rows stay;
    another shape, or a scratch made anew, makes it again; the pointers are
    the scratch's own and the bitmap halves alternate."""
    monkeypatch.setattr(K1, "_bwd_plan", {})
    made = []
    real = K1.backward_scratch
    monkeypatch.setattr(K1, "backward_scratch", lambda *a: made.append(a[2:4]) or real(*a))
    lib = fake_cuda[K1.NAME]
    g, idx, w = torch.zeros(100, 16), torch.zeros(400, dtype=torch.int32), torch.ones(400)
    for _ in range(3):
        K1.embedding_bag_backward(g, idx, w, 1000, masked=True)
    K1.embedding_bag_backward(g[:50], idx[:200], w[:200], 1000, masked=True)
    K1.embedding_bag_backward(g, idx, w, 1000, masked=True)
    assert made == [(400, 1000), (200, 1000), (400, 1000)]
    K1._bwd_scratch.clear()
    K1.embedding_bag_backward(g, idx, w, 1000, masked=True)
    assert made[-1] == (400, 1000) and len(made) == 4
    sc = K1._bwd_scratch[(torch.device("cpu"), 77)]
    launches = [a for s_, a in lib.calls if s_ == K1.BWD_SYMBOL]
    assert launches[-1][17:30] == tuple(sc[k].data_ptr() for k in K1.BWD_POINTERS)
    halves = [a[14] for a in launches[:3]]  # the first scratch's: 32 words a half
    assert halves[1] - halves[0] == 4 * 32 and halves[2] == halves[0]
    assert [a[15] for a in launches[:2]] == halves[1::-1]


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
    assert [a[-3:-1] for a in launches] == [(1, 1), (1, 1)]


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
