"""K6' bf16 (csrc/flash_attention_backward.cu, the wgmma kernels) modelled
in numpy on the CPU, where no CUDA kernel runs.

The model follows the kernels' tile plan and arithmetic, with the tile
sizes read from the source: the dK/dV pass (a CTA per 128 keys, a consumer
warpgroup per 64 of them, streaming the group's query heads in order and
their query tiles from ``first_query_tile`` on) and the dQ pass (a CTA per
128 query rows, 64 a warpgroup, streaming key tiles of 64 up to its
diagonal); a warpgroup skips a tile that is wholly masked for it, and masks
only the tiles that hold a masked pair; P is rounded to bf16 for dV; dS goes
into dK and dQ as two bf16 parts, hi = bf16(dS) and lo = bf16(dS - hi),
lo's product first.  The plan itself is checked for coverage (every kept
pair once in each pass), for loading no tile that is wholly masked, for its
mask flags and for its longest-first order.  The model runs in f64 and is
held against ``ref.flash_attention_backward_ref`` on the same inputs (v in
bf16, so that the plain version rounds P as the kernel does) at 2e-5, the
reference's flash tolerance (rtol and atol; gradients of unit-normal
inputs): the two-part dS keeps each element to 2^-18 of itself and meets it
(0.7 of the limit at most), where one bf16 rounding (2^-9) misses it 60 to
400 times over.  A plan that starts its
dK/dV loop one query tile late (the planted fault of chip_smoke.py) fails
the same check.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as K6

SRC = (build.CSRC / f"{K6.NAME_BWD}.cu").read_text()
TOL = 2e-5


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


OWN_ROWS = _const("kOwnRows")  # keys (dK/dV) or query rows (dQ) a CTA owns
WG_ROWS = _const("kWgRows")  # of those, a consumer warpgroup's
KEY_STEP = _const("kKeyStep")  # keys a dQ step streams
QUERY_STEP = _const("kQueryStep")  # query rows a dK/dV step streams


def query_step(dh: int) -> int:
    """Query rows a dK/dV step streams (the same at every head dim)."""
    return QUERY_STEP


def first_query_tile(j: int, causal: bool, ratio: int, late: int = 0) -> int:
    """The source's ``first_query_tile``; ``late`` tiles later for the
    planted fault."""
    return (j * ratio if causal else 0) + late


def dkdv_plan(S: int, dh: int, causal: bool, late: int = 0):
    """For each key tile j (launch order: j ascending, the longest first),
    its steps in order: (query head offset in the group, q0, and per
    warpgroup None when it skips the tile, else whether it masks)."""
    qs = query_step(dh)
    n_q = -(-S // qs)
    plan = []
    for j in range(-(-S // OWN_ROWS)):
        k0, steps = j * OWN_ROWS, []
        for i in range(first_query_tile(j, causal, OWN_ROWS // qs, late), n_q):
            q0, wgs = i * qs, []
            for w in range(OWN_ROWS // WG_ROWS):
                kw0 = k0 + w * WG_ROWS
                if kw0 >= S or (causal and q0 + qs - 1 < kw0):
                    wgs.append(None)
                else:
                    wgs.append(q0 + qs > S or kw0 + WG_ROWS > S
                               or (causal and q0 < kw0 + WG_ROWS - 1))
            steps.append((q0, wgs))
        plan.append(steps)
    return plan


def dq_plan(S: int, causal: bool):
    """For each query tile i in launch order (blockIdx.x ascending: i from
    the last, the longest first), its key tiles k0 and per warpgroup None
    (skipped) or whether it masks."""
    n = -(-S // OWN_ROWS)
    plan = []
    for i in reversed(range(n)):
        q0 = i * OWN_ROWS
        kv_end = min(q0 + OWN_ROWS, S) if causal else S
        steps = []
        for jt in range(-(-kv_end // KEY_STEP)):
            k0, wgs = jt * KEY_STEP, []
            for w in range(OWN_ROWS // WG_ROWS):
                qw0 = q0 + w * WG_ROWS
                if qw0 >= S or (causal and k0 > qw0 + WG_ROWS - 1):
                    wgs.append(None)
                else:
                    wgs.append(k0 + KEY_STEP > S or qw0 + WG_ROWS > S
                               or (causal and k0 + KEY_STEP - 1 > qw0))
            steps.append((k0, wgs))
        plan.append((i, steps))
    return plan


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even, as __floats2bfloat162_rn), in f64."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).double().numpy()


def split_bf16(x: np.ndarray):
    """The kernel's split of dS (f32): hi = bf16(x), lo = bf16(x - hi), the
    subtraction exact in f32."""
    x32 = x.astype(np.float32)
    hi = _bf16(x32)
    return hi, _bf16(x32 - hi.astype(np.float32))


def round_once(x: np.ndarray):
    """dS rounded once to bf16: no low part."""
    return _bf16(x.astype(np.float32)), np.zeros_like(x)


def model_backward(q, k, v, o, lse, do, causal: bool, late: int = 0, split=split_bf16):
    """(dq, dk, dv) by the kernels' plan and arithmetic, in f64 numpy; P is
    rounded to bf16 from f64, as the plain version rounds it here."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    delta = (do * o).sum(-1)  # [B, S, H]
    qs = query_step(dh)

    def rows(x, r0, n):  # rows r0.. of x's axis 0, zeros past S (TMA's fill)
        out = np.zeros((n,) + x.shape[1:])
        m = max(0, min(n, S - r0))
        out[:m] = x[r0:r0 + m]
        return out

    def probs(s, lse_rows, keys, queries, masked):
        # s [keys, queries]; 0 where masked (a causal future key, past S)
        p = np.exp(s * scale - lse_rows[None, :])
        if masked:
            bad = (queries[None, :] >= S) | (keys[:, None] >= S)
            if causal:
                bad |= keys[:, None] > queries[None, :]
            p = np.where(bad, 0.0, p)
        return p

    dq = np.zeros_like(q)
    dk = np.zeros(k.shape)
    dv = np.zeros(k.shape)
    for b in range(B):
        for hk in range(Hkv):
            for j, steps in enumerate(dkdv_plan(S, dh, causal, late)):
                k0 = j * OWN_ROWS
                acc_k = np.zeros((OWN_ROWS, dh))
                acc_v = np.zeros((OWN_ROWS, dh))
                kt, vt = rows(k[b, :, hk], k0, OWN_ROWS), rows(v[b, :, hk], k0, OWN_ROWS)
                for h in range(hk * group, (hk + 1) * group):  # the group's heads in order
                    for q0, wgs in steps:
                        qt, gt = rows(q[b, :, h], q0, qs), rows(do[b, :, h], q0, qs)
                        lse_t = rows(lse[b, h], q0, qs)
                        d_t = rows(delta[b, :, h], q0, qs)
                        for w, masked in enumerate(wgs):
                            if masked is None:
                                continue
                            r = slice(w * WG_ROWS, (w + 1) * WG_ROWS)
                            keys = k0 + np.arange(r.start, r.stop)
                            pt = probs(kt[r] @ qt.T, lse_t, keys, q0 + np.arange(qs), masked)
                            dst = pt * (vt[r] @ gt.T - d_t[None, :])
                            acc_v[r] += _bf16(pt) @ gt  # P as K6's P . V takes it
                            hi, lo = split(dst)
                            acc_k[r] += lo @ qt
                            acc_k[r] += hi @ qt
                n = min(OWN_ROWS, S - k0)
                dk[b, k0:k0 + n, hk] = acc_k[:n] * scale
                dv[b, k0:k0 + n, hk] = acc_v[:n]
        for h in range(H):
            hk = h // group
            for i, steps in dq_plan(S, causal):
                q0 = i * OWN_ROWS
                qt, gt = rows(q[b, :, h], q0, OWN_ROWS), rows(do[b, :, h], q0, OWN_ROWS)
                lse_t, d_t = rows(lse[b, h], q0, OWN_ROWS), rows(delta[b, :, h], q0, OWN_ROWS)
                acc = np.zeros((OWN_ROWS, dh))
                for k0, wgs in steps:
                    kt, vt = rows(k[b, :, hk], k0, KEY_STEP), rows(v[b, :, hk], k0, KEY_STEP)
                    for w, masked in enumerate(wgs):
                        if masked is None:
                            continue
                        r = slice(w * WG_ROWS, (w + 1) * WG_ROWS)
                        queries = q0 + np.arange(r.start, r.stop)
                        p = probs(kt @ qt[r].T, lse_t[r], k0 + np.arange(KEY_STEP), queries,
                                  masked).T
                        ds = p * (gt[r] @ vt.T - d_t[r, None])
                        hi, lo = split(ds)
                        acc[r] += lo @ kt
                        acc[r] += hi @ kt
                n = min(OWN_ROWS, S - q0)
                dq[b, q0:q0 + n, h] = acc[:n] * scale
    return dq, dk, dv


CASES = [  # B, S, H, Hkv, dh, causal
    (1, 130, 4, 2, 64, True),  # ragged, GQA
    (2, 45, 2, 2, 80, True),  # one tile, ragged
    (1, 130, 2, 2, 80, False),  # full
    (1, 200, 4, 1, 96, True),  # a group of 4
    (1, 130, 8, 1, 128, True),  # a group of 8
    (1, 45, 2, 1, 128, False),
    (1, 256, 2, 2, 64, True),  # whole tiles
    (2, 64, 4, 2, 16, True),  # lm_smoke's head dim: one 16-column region
    (2, 45, 4, 1, 16, False),  # a group of 4, as the registry's smokes cut it
    (1, 200, 8, 4, 32, True),  # lm-small's layer: one 32-column region
    (1, 130, 2, 2, 32, False),
]


def _inputs(B, S, H, Hkv, dh, causal, seed=0):
    """bf16-valued inputs, o and lse from the plain forward, in f64."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, S, H, dh)) for _ in range(2))
    k, v = (rng.normal(size=(B, S, Hkv, dh)) for _ in range(2))
    q, k, v, do = (_bf16(x) for x in (q, k, v, do))
    o, lse = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                                     return_lse=True)
    return q, k, v, o.numpy(), lse.numpy(), do


def _plain(q, k, v, o, lse, do, causal):
    """The plain version in f64 with v in bf16: P rounded for dV."""
    t = {n: torch.from_numpy(x) for n, x in dict(q=q, k=k, o=o, lse=lse, do=do).items()}
    vb = torch.from_numpy(v).to(torch.bfloat16)
    return [x.numpy() for x in ref.flash_attention_backward_ref(
        t["q"], t["k"], vb, t["o"], t["lse"], t["do"], causal)]


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def test_source_constants():
    """The model's tile sizes are the source's, and its first_query_tile
    is the source's expression."""
    assert (OWN_ROWS, WG_ROWS, KEY_STEP) == (128, 64, 64)
    assert QUERY_STEP == 64
    assert "  return causal ? j * ratio : 0;" in SRC
    assert "first_query_tile(j, causal, kOwnRows / QS)" in SRC


@pytest.mark.parametrize("S", [45, 128, 130, 1000])
@pytest.mark.parametrize("dh", [16, 32, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_plan_covers_each_kept_pair_once(S, dh, causal):
    """Each pass visits every kept (query, key) pair in exactly one active
    warpgroup step, loads no tile that every warpgroup skips, masks exactly
    the steps that hold a dropped pair, and launches the longest work first."""
    qs = query_step(dh)
    kept = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)  # [query, key]
    seen = np.zeros((S, S), int)
    lengths = []
    for j, steps in enumerate(dkdv_plan(S, dh, causal)):
        lengths.append(len(steps))
        for q0, wgs in steps:
            assert any(m is not None for m in wgs), "a tile no warpgroup uses was loaded"
            for w, masked in enumerate(wgs):
                if masked is None:
                    continue
                kw0 = j * OWN_ROWS + w * WG_ROWS
                block = kept[q0:q0 + qs, kw0:kw0 + WG_ROWS]
                full = block.shape == (qs, WG_ROWS) and block.all()
                assert masked == (not full)
                seen[q0:q0 + qs, kw0:kw0 + WG_ROWS] += block
    assert (seen == kept).all()
    assert lengths == sorted(lengths, reverse=True)
    seen[:] = 0
    lengths = []
    for i, steps in dq_plan(S, causal):
        lengths.append(len(steps))
        for k0, wgs in steps:
            assert any(m is not None for m in wgs), "a tile no warpgroup uses was loaded"
            for w, masked in enumerate(wgs):
                if masked is None:
                    continue
                qw0 = i * OWN_ROWS + w * WG_ROWS
                block = kept[qw0:qw0 + WG_ROWS, k0:k0 + KEY_STEP]
                full = block.shape == (WG_ROWS, KEY_STEP) and block.all()
                assert masked == (not full)
                seen[qw0:qw0 + WG_ROWS, k0:k0 + KEY_STEP] += block
    assert (seen == kept).all()
    assert lengths == sorted(lengths, reverse=True)


def test_causal_key_tile_starts_at_its_diagonal():
    """A causal key tile's first query tile holds its first key's own row:
    the tile the planted fault skips."""
    for dh in (16, 32, 80, 128):
        for j, steps in enumerate(dkdv_plan(1000, dh, True)):
            q0, wgs = steps[0]
            assert q0 == j * OWN_ROWS and wgs[0] is True


@pytest.mark.parametrize("S,causal", [(1000, True), (130, False), (4096, True)])
def test_dq_order_is_a_function_of_step_and_tile(S, causal):
    """dQ of a query tile sums its key tiles in one CTA, in ascending order
    (the kernel's loop over them): a function of (query tile, key tile)
    alone, the same for every batch, head and group, so two launches sum
    in the same order."""
    for i, steps in dq_plan(S, causal):
        k0s = [k0 for k0, _ in steps]
        assert k0s == list(range(0, KEY_STEP * len(steps), KEY_STEP))
    dq = SRC[SRC.index("flash_attention_bwd_dq_wgmma_kernel(const __grid_constant__"):]
    assert "  for (int jt = 0; jt < n_k; ++jt) {" in dq
    assert "auto step_at = [&](int it) { return make_int2(hk, it * KS); };" in dq


@pytest.mark.parametrize("B,S,H,Hkv,dh,causal", CASES)
def test_model_matches_the_plain_version(B, S, H, Hkv, dh, causal):
    args = _inputs(B, S, H, Hkv, dh, causal)
    got = model_backward(*args, causal)
    want = _plain(*args, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("B,S,H,Hkv,dh,causal", [CASES[0], CASES[4], CASES[9]])
def test_one_rounding_of_ds_is_not_enough(B, S, H, Hkv, dh, causal):
    """dS rounded once to bf16 (lo dropped) misses the tolerance that the
    two parts meet: the reason for the second product."""
    args = _inputs(B, S, H, Hkv, dh, causal)
    got = model_backward(*args, causal, split=round_once)
    want = _plain(*args, causal)
    with pytest.raises(AssertionError):
        _close(got[1], want[1], "dk")


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_planted_late_start_is_caught(dh):
    """The planted fault (every dK/dV loop one query tile late) fails the
    check on dk; dq, from the other pass, still matches."""
    args = _inputs(1, 200, 2, 1, dh, True, seed=1)
    got = model_backward(*args, True, late=1)
    want = _plain(*args, True)
    _close(got[0], want[0], "dq")
    for name, g, w in zip(("dk", "dv"), got[1:], want[1:]):
        with pytest.raises(AssertionError):
            _close(g, w, name)
