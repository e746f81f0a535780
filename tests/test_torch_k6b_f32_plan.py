"""K6' f32 (csrc/flash_attention_backward.cu, the mma.sync kernels) modelled
in numpy on the CPU, where no CUDA kernel runs.

Read from the source: the CTA's warps, the rows a ring step streams at each
head dim and the rows of a sub-step in each pass, the tiles' pitch and
their XOR swizzle, the fragments' address arithmetic and register orders
(which head dim or row each lane's A and B registers take, which
accumulator register becomes which A register) and ``first_query_tile``.
Checked:

* the layout: every 16-byte read (rows 8j + g, columns 16p + 4t) and every
  scalar read (rows 8j + 2t and 8j + 2t + 1, column 8n + g) meets 32
  banks, at every head dim, where no plain pitch serves both reads;
* the plan: each kept (query, key) pair lies in exactly one sub-step of
  one warp in each pass, a warp skips just sub-steps that hold no kept pair
  of its own, and masks just those that hold a dropped one;
* the fragment orders: one warp of ``mma.sync.m16n8k8`` simulated lane by
  lane on the PTX fragment layouts, through the source's loads from the
  swizzled tiles, gives X . Y^T and then M . Y of a plain matrix product,
  with the accumulator of the first read as the A fragment of the second;
* the arithmetic: the backward by the kernels' plan with every product run
  as 3xTF32 (tf32 as a mask of the low 13 mantissa bits, each mma's sum
  rounded to f32, a k-step's terms summed apart and added to the product's
  sum in f32), held against ``ref.flash_attention_backward_ref`` at 2e-5
  (rtol and atol, the reference's f32 tolerance); with the mma's additions
  truncated it still meets 2e-5, where sums kept in the mma across the
  whole loop do not; one tf32 product a pair misses it, and so does a plan
  whose dK/dV loop starts one query tile late (the planted fault of
  chip_smoke.py).
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
HEAD_DIMS = (16, 32, 64, 80, 96, 128)


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


WARPS = _const("kWarpsF32")
OWN = 16 * WARPS  # rows a CTA owns: kOwnF32
_STEP = re.search(r"kStep = D > (\d+) \? (\d+) : (\d+);", SRC)
_SWZ = re.search(r"int swz\(int r\) \{ return (.+); \}", SRC).group(1)
swz = eval("lambda r: " + _SWZ)  # C and Python rank <<, >>, &, ^, | alike


def step(dh: int) -> int:
    """Rows a ring step streams: query rows (dK/dV) or keys (dQ)."""
    return int(_STEP.group(2)) if dh > int(_STEP.group(1)) else int(_STEP.group(3))


SUB_KV = _const("kSubKvF32")  # query rows of a dK/dV sub-step
SUB_Q = _const("kSubQF32")  # keys of a dQ sub-step


def pitch(dh: int) -> int:
    """Floats a tile row: dh rounded up to 32 (the source's kLd)."""
    assert "kLd = (D + 31) / 32 * 32;" in SRC
    return (dh + 31) // 32 * 32


def at(r, c, dh):
    """The float offset of column c of tile row r."""
    return r * pitch(dh) + (c ^ swz(r))


def first_query_tile(j: int, causal: bool, ratio: int, late: int = 0) -> int:
    """The source's ``first_query_tile``; ``late`` tiles later for the
    planted fault."""
    return (j * ratio if causal else 0) + late


# ------------------------------------------------------------- source orders

def _a_order():
    """a_frags: [k-step][reg] -> (row: 0 for g, 1 for g + 8; the float of the
    16-byte piece)."""
    order = [[None] * 4 for _ in range(2)]
    for row, comp, ks, reg in re.findall(
            r"split_tf32\(x([ab])\.([xyzw]), ab\[(\d)\]\[(\d)\]", SRC):
        order[int(ks)][int(reg)] = ("ab".index(row), "xyzw".index(comp))
    return order


def _b_order():
    """product_nt: [k-step] -> (the floats of Y's 16-byte piece as b0, b1)."""
    reg = {int(r): "xyzw".index(c) for c, r in re.findall(r"split_tf32\(yv\.([xyzw]), bb\[(\d)\]", SRC)}
    steps = re.findall(r"mma_3xtf32\(part, ab\[(\d)\], as\[\d\], bb\[(\d)\], bb\[(\d)\]", SRC)
    return {int(k): (reg[int(b0)], reg[int(b1)]) for k, b0, b1 in steps}


def _m_order():
    """product_nn: A register -> the accumulator register 4j + e it takes."""
    found = re.findall(r"split_tf32\(m\[4 \* j(?: \+ (\d))?\], ab\[(\d)\]", SRC)
    return {int(reg): int(e or 0) for e, reg in found}


# The source's address arithmetic of the fragments, which _product_nt and
# _product_nn below repeat.
NT_ADDRESSES = (
    "const int col0 = (4 * (lane & 3)) ^ swz(g), col1 = (16 + 4 * (lane & 3)) ^ swz(g);",
    "const float* x0 = x + g * Ld;",
    "const float* y0 = y + g * Ld;",
    "const int col = 32 * (p >> 1) + ((p & 1) ? col1 : col0);",
    "a_frags(ab, as, x0, x0 + 8 * Ld, col);",
    "*reinterpret_cast<const float4*>(y0 + 8 * j * Ld + col);",
)
NN_ADDRESSES = (
    "col0[i] = (8 * i + g) ^ swz(2 * t);",
    "col1[i] = (8 * i + g) ^ swz(2 * t + 1);",
    "const float* y0 = y + 2 * t * Ld;",
    "const float* y1 = y0 + Ld;",
    "const int at = 8 * j * Ld + 32 * (n >> 2);",
    "y0[at + col0[n & 3]]", "y1[at + col1[n & 3]]",
)


def test_source_constants():
    """The model's sizes and expressions are the source's."""
    assert (WARPS, OWN) == (8, 128)
    assert [step(d) for d in HEAD_DIMS] == [64, 64, 64, 64, 64, 32]
    assert (SUB_KV, SUB_Q) == (16, 32)
    assert "constexpr int SUB = kSubKvF32;" in SRC and "constexpr int SUB = kSubQF32;" in SRC
    assert _const("kStagesF32") == 2
    assert "  return causal ? j * ratio : 0;" in SRC
    assert "first_query_tile(j, causal, kOwnF32 / QS)" in SRC
    assert _a_order() == [[(0, 0), (1, 0), (0, 1), (1, 1)], [(0, 2), (1, 2), (0, 3), (1, 3)]]
    assert _b_order() == {0: (0, 1), 1: (2, 3)}
    assert _m_order() == {0: 0, 1: 2, 2: 1, 3: 3}
    for line in NT_ADDRESSES + NN_ADDRESSES:
        assert line in SRC, line


# -------------------------------------------------------------------- layout

def _vec_banks(offset):
    """Banks of one 8-lane phase of 16-byte reads at word offsets: 32 when
    free of conflicts."""
    return {(o + w) % 32 for o in offset for w in range(4)}


def _conflict_free(off, dh):
    """Both reads of rows 8j.. of a tile (off(r, c) the word offset) meet 32
    banks: 16-byte pieces (lanes g, t: row g, column 16p + 4t; phases of 8
    lanes) and single floats (lanes g, t: rows 2t or 2t + 1, column 8n + g)."""
    for p in range(dh // 16):
        for phase in range(4):
            lanes = range(8 * phase, 8 * phase + 8)
            if len(_vec_banks([off(ln >> 2, 16 * p + 4 * (ln & 3)) for ln in lanes])) != 32:
                return False
    for n in range(dh // 8):
        for odd in (0, 1):
            banks = {off(2 * (ln & 3) + odd, 8 * n + (ln >> 2)) % 32 for ln in range(32)}
            if len(banks) != 32:
                return False
    return True


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_swizzle_serves_both_reads(dh):
    """The swizzled layout keeps a row's columns distinct and below its
    pitch, its 16-byte pieces whole and aligned, and both reads free of bank
    conflicts at every row block; no plain pitch from dh to dh + 32 does."""
    ld = pitch(dh)
    for r in range(16):
        cols = [c ^ swz(r) for c in range(dh)]
        assert len(set(cols)) == dh and max(cols) < ld
        for c in range(0, dh, 4):
            assert (c ^ swz(r)) % 4 == 0 and [(c + w) ^ swz(r) for w in range(4)] == \
                [(c ^ swz(r)) + w for w in range(4)]
    for j in range(4):
        assert _conflict_free(lambda r, c: at(8 * j + r, c, dh), dh)
    assert not any(_conflict_free(lambda r, c, ld_=ld_: r * ld_ + c, dh)
                   for ld_ in range(dh, dh + 33, 4))


# ---------------------------------------------------------------------- plan

def dkdv_plan(S: int, dh: int, causal: bool, late: int = 0):
    """For each key tile j (launch order), its ring steps in order (one
    query head's; the group's heads repeat them): (q0, sub-steps), a
    sub-step (r0, and per warp None when it skips it, else whether it
    masks)."""
    qs, sub = step(dh), SUB_KV
    n_q = -(-S // qs)
    plan = []
    for j in range(-(-S // OWN)):
        k0, steps = j * OWN, []
        for i in range(first_query_tile(j, causal, OWN // qs, late), n_q):
            subs = []
            for r0 in range(i * qs, (i + 1) * qs, sub):
                warps = []
                for w in range(WARPS):
                    kw0 = k0 + 16 * w
                    if kw0 >= S or r0 >= S or (causal and r0 + sub - 1 < kw0):
                        warps.append(None)
                    else:
                        warps.append(r0 + sub > S or kw0 + 16 > S or (causal and r0 < kw0 + 15))
                subs.append((r0, warps))
            steps.append((i * qs, subs))
        plan.append(steps)
    return plan


def dq_plan(S: int, dh: int, causal: bool):
    """For each query tile i in launch order (the last first), its ring
    steps of keys: (first key, sub-steps), a sub-step (k0, and per warp None
    (skipped) or whether it masks)."""
    ks, sub = step(dh), SUB_Q
    plan = []
    for i in reversed(range(-(-S // OWN))):
        q0 = i * OWN
        kv_end = min(q0 + OWN, S) if causal else S
        steps = []
        for jt in range(-(-kv_end // ks)):
            subs = []
            for k0 in range(jt * ks, (jt + 1) * ks, sub):
                warps = []
                for w in range(WARPS):
                    qw0 = q0 + 16 * w
                    if qw0 >= S or k0 >= S or (causal and k0 > qw0 + 15):
                        warps.append(None)
                    else:
                        warps.append(k0 + sub > S or qw0 + 16 > S or (causal and k0 + sub - 1 > qw0))
                subs.append((k0, warps))
            steps.append((jt * ks, subs))
        plan.append((i, steps))
    return plan


@pytest.mark.parametrize("S", [45, 128, 130, 1000])
@pytest.mark.parametrize("dh", [16, 32, 80, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_plan_covers_each_kept_pair_once(S, dh, causal):
    """Each pass visits every kept (query, key) pair in exactly one active
    warp sub-step; a warp skips only sub-steps without a kept pair of its
    own, masks exactly those that hold a dropped pair, and the work runs
    longest first."""
    kept = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)  # [query, key]
    seen = np.zeros((S, S), int)
    lengths = []
    for j, steps in enumerate(dkdv_plan(S, dh, causal)):
        lengths.append(len(steps))
        for _, subs in steps:
            for r0, warps in subs:
                for w, masked in enumerate(warps):
                    kw0 = j * OWN + 16 * w
                    block = kept[r0:r0 + SUB_KV, kw0:kw0 + 16]
                    if masked is None:
                        assert not block.any()
                        continue
                    assert masked == (not (block.shape == (SUB_KV, 16) and block.all()))
                    seen[r0:r0 + SUB_KV, kw0:kw0 + 16] += block
    assert (seen == kept).all()
    assert lengths == sorted(lengths, reverse=True)
    seen[:] = 0
    lengths = []
    for i, steps in dq_plan(S, dh, causal):
        lengths.append(len(steps))
        for _, subs in steps:
            for k0, warps in subs:
                for w, masked in enumerate(warps):
                    qw0 = i * OWN + 16 * w
                    block = kept[qw0:qw0 + 16, k0:k0 + SUB_Q]
                    if masked is None:
                        assert not block.any()
                        continue
                    assert masked == (not (block.shape == (16, SUB_Q) and block.all()))
                    seen[qw0:qw0 + 16, k0:k0 + SUB_Q] += block
    assert (seen == kept).all()
    assert lengths == sorted(lengths, reverse=True)


def test_causal_key_tile_starts_at_its_diagonal():
    """A causal key tile's first query step holds its first key's own row:
    the step the planted fault skips."""
    for dh in (32, 80, 128):
        for j, steps in enumerate(dkdv_plan(1000, dh, True)):
            q0, subs = steps[0]
            assert q0 == j * OWN and subs[0][0] == q0 and subs[0][1][0] is True


# ----------------------------------------------------------- fragment orders

def _mma(a, b, c):
    """One warp's mma.sync.m16n8k8 (row.col, f32 accumulate) on the PTX
    fragment layouts: a [32, 4], b [32, 2], c [32, 4] registers by lane."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[ln]
        B[t, g], B[t + 4, g] = b[ln]
    C = A @ B
    out = c.copy()
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        out[ln] += [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]
    return out


def _tile(x, dh):
    """Rows of x in shared memory at the source's pitch and swizzle."""
    sm = np.full(x.shape[0] * pitch(dh), np.nan)
    for r in range(x.shape[0]):
        for c in range(dh):
            sm[at(r, c, dh)] = x[r, c]
    return sm


def _product_nt(xs, ys, n, dh):
    """c [32 lanes, n / 2] of product_nt: the warp's 16 rows of xs against n
    rows of ys, both swizzled tiles, through the source's loads and orders."""
    a_ord, b_ord = _a_order(), _b_order()
    Ld = pitch(dh)
    c = np.zeros((n // 8, 32, 4))
    for p in range(dh // 16):
        a = np.zeros((2, 32, 4))
        b = np.zeros((n // 8, 2, 32, 2))
        for ln in range(32):
            g, t = ln >> 2, ln & 3
            col0, col1 = (4 * t) ^ swz(g), (16 + 4 * t) ^ swz(g)
            col = 32 * (p >> 1) + (col1 if p & 1 else col0)
            x0, y0 = g * Ld, g * Ld  # offsets of x0 and y0
            piece = [xs[x0 + col:][:4], xs[x0 + 8 * Ld + col:][:4]]
            for ks in range(2):
                a[ks, ln] = [piece[row][w] for row, w in a_ord[ks]]
            for j in range(n // 8):
                yv = ys[y0 + 8 * j * Ld + col:][:4]
                for ks in range(2):
                    b[j, ks, ln] = [yv[w] for w in b_ord[ks]]
        for j in range(n // 8):
            for ks in range(2):
                c[j] = _mma(a[ks], b[j, ks], c[j])
    return np.concatenate(list(c), axis=1)  # register 4j + e


def _product_nn(m, ys, n, dh):
    """acc [32 lanes, dh / 2] of product_nn: m [32, n / 2] accumulator
    registers times n rows of the swizzled tile ys."""
    m_ord = _m_order()
    Ld = pitch(dh)
    acc = np.zeros((dh // 8, 32, 4))
    for j in range(n // 8):
        a = np.array([[m[ln, 4 * j + m_ord[r]] for r in range(4)] for ln in range(32)])
        for nt in range(dh // 8):
            b = np.zeros((32, 2))
            for ln in range(32):
                g, t = ln >> 2, ln & 3
                col0 = [(8 * i + g) ^ swz(2 * t) for i in range(4)]
                col1 = [(8 * i + g) ^ swz(2 * t + 1) for i in range(4)]
                y0 = 2 * t * Ld
                y1 = y0 + Ld
                off = 8 * j * Ld + 32 * (nt >> 2)
                b[ln] = [ys[y0 + off + col0[nt & 3]], ys[y1 + off + col1[nt & 3]]]
            acc[nt] = _mma(a, b, acc[nt])
    return np.concatenate(list(acc), axis=1)


def _as_matrix(regs, cols):
    """[16, cols] from accumulator registers: 4j + e of lane (g, t) at row
    g + 8 (e >> 1), column 8j + 2t + (e & 1)."""
    out = np.zeros((16, cols))
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        for r in range(cols // 2):
            j, e = divmod(r, 4)
            out[g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)] = regs[ln, r]
    return out


@pytest.mark.parametrize("n", [SUB_KV, SUB_Q])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_fragment_orders_match_a_plain_product(dh, n, rng):
    """S = X . Y^T (the first products) and M . Y (the second, M read from
    the first's accumulator as it stands) by the source's lane orders, on
    small integers (exact), equal the plain products; warp 1's rows of an
    owned tile of 32 rows, a sub-step of n rows of a streamed tile."""
    x = rng.integers(-4, 5, size=(32, dh)).astype(np.float64)
    y = rng.integers(-4, 5, size=(n, dh)).astype(np.float64)
    z = rng.integers(-4, 5, size=(n, dh)).astype(np.float64)
    xs, ys, zs = _tile(x, dh), _tile(y, dh), _tile(z, dh)
    warp = 1
    c = _product_nt(xs[16 * warp * pitch(dh):], ys, n, dh)
    s = x[16 * warp:16 * warp + 16] @ y.T
    np.testing.assert_array_equal(_as_matrix(c, n), s)
    acc = _product_nn(c, zs, n, dh)
    np.testing.assert_array_equal(_as_matrix(acc, dh), s @ z)


# ---------------------------------------------------------------- arithmetic

TF32_MASK = np.uint32(0xFFFFE000)


def _tf32(x):
    """f32 as the tensor core reads a tf32 operand: the low 13 mantissa bits
    dropped."""
    return (np.asarray(x, np.float32).view(np.uint32) & TF32_MASK).view(np.float32)


def _ksteps(dh: int, nt: bool):
    """The reduction's k-steps of 8 in the source's order, in the groups
    that are summed apart before one f32 add to the sum (``add4``): head
    dims 16p + 4t + {0, 1} and {2, 3} for the first products (nt), the two
    k-steps of a p together; rows 8j..8j+7 for the second, one a group."""
    if not nt:
        return [[np.arange(8 * j, 8 * j + 8)] for j in range(dh // 8)]
    return [[np.array([16 * p + 4 * t + 2 * half + w for t in range(4) for w in (0, 1)])
             for half in (0, 1)] for p in range(dh // 16)]


def _to_f32(x, truncate):
    """f64 to f32, to nearest or (``truncate``) toward zero."""
    x32 = x.astype(np.float32)
    if truncate:
        over = np.abs(x32.astype(np.float64)) > np.abs(x)
        x32[over] = np.nextafter(x32[over], np.float32(0))
    return x32


def _product(c, a, b, groups, products=3, truncate=False, apart=True):
    """c += a . b (a [M, K], b [K, N], f32) in k-steps, each mma.sync's sum
    rounded to f32 (to nearest, or toward zero with ``truncate``) into a
    group's own sum that is then added to c in f32 (or, not ``apart``,
    into c itself): three tf32 products (small . big, big . small, big .
    big) or one."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    terms = ((a_small, b_big), (a_big, b_small), (a_big, b_big))[3 - products:]
    for group in groups:
        t = np.zeros(c.shape, np.float32) if apart else c
        for idx in group:
            for x, y in terms:
                t = _to_f32(t.astype(np.float64) + x[:, idx].astype(np.float64)
                            @ y[idx].astype(np.float64), truncate)
        c = c + t if apart else t
    return c


def model_backward(q, k, v, o, lse, do, causal: bool, late: int = 0, **arith):
    """(dq, dk, dv) by the kernels' plan and 3xTF32 arithmetic, f32 numpy:
    a CTA's warps as row blocks (a skipped warp adds nothing), P = 2^(s
    scale log2 e - lse log2 e), dS = P (dP - D); ``arith`` goes to
    ``_product``."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    f32 = np.float32
    scale = f32(1.0 / math.sqrt(dh))
    log2e = f32(1.4426950408889634)
    delta = (do.astype(np.float64) * o).sum(-1).astype(f32)  # [B, S, H]
    nt = _ksteps(dh, True)

    def rows(x, r0, n):  # rows r0.. of x's axis 0, zeros past S (cp.async's fill)
        out = np.zeros((n,) + x.shape[1:], f32)
        m = max(0, min(n, S - r0))
        out[:m] = x[r0:r0 + m]
        return out

    def probs(s, lse_rows, row_ids, col_ids, row_is_key):
        p = np.exp2(s * (scale * log2e) - lse_rows * log2e).astype(f32)
        keys, queries = (row_ids[:, None], col_ids[None, :]) if row_is_key else \
            (col_ids[None, :], row_ids[:, None])
        bad = (queries >= S) | (keys >= S)
        if causal:
            bad |= keys > queries
        return np.where(bad, f32(0), p)

    dq = np.zeros(q.shape, f32)
    dk = np.zeros(k.shape, f32)
    dv = np.zeros(k.shape, f32)
    for b in range(B):
        for hk in range(Hkv):
            for j, steps in enumerate(dkdv_plan(S, dh, causal, late)):
                k0 = j * OWN
                acc_k = np.zeros((OWN, dh), f32)
                acc_v = np.zeros((OWN, dh), f32)
                kt, vt = rows(k[b, :, hk], k0, OWN), rows(v[b, :, hk], k0, OWN)
                for h in range(hk * group, (hk + 1) * group):
                    for _, subs in steps:
                        for q0, warps in subs:
                            qt, gt = rows(q[b, :, h], q0, SUB_KV), rows(do[b, :, h], q0, SUB_KV)
                            lse_t = rows(lse[b, h], q0, SUB_KV)[None, :]
                            d_t = rows(delta[b, :, h], q0, SUB_KV)[None, :]
                            for w, masked in enumerate(warps):
                                if masked is None:
                                    continue
                                r = slice(16 * w, 16 * w + 16)
                                zero = np.zeros((16, SUB_KV), f32)
                                s = _product(zero, kt[r], qt.T, nt, **arith)
                                dp = _product(zero, vt[r], gt.T, nt, **arith)
                                p = probs(s, lse_t, k0 + np.arange(r.start, r.stop),
                                          q0 + np.arange(SUB_KV), True)
                                ds = (p * (dp - d_t)).astype(f32)
                                acc_v[r] = _product(acc_v[r], p, gt, _ksteps(SUB_KV, False), **arith)
                                acc_k[r] = _product(acc_k[r], ds, qt, _ksteps(SUB_KV, False), **arith)
                n = min(OWN, S - k0)
                dk[b, k0:k0 + n, hk] = acc_k[:n] * scale
                dv[b, k0:k0 + n, hk] = acc_v[:n]
        for h in range(H):
            hk = h // group
            for i, steps in dq_plan(S, dh, causal):
                q0 = i * OWN
                qt, gt = rows(q[b, :, h], q0, OWN), rows(do[b, :, h], q0, OWN)
                lse_t, d_t = rows(lse[b, h], q0, OWN), rows(delta[b, :, h], q0, OWN)
                acc = np.zeros((OWN, dh), f32)
                for _, subs in steps:
                    for k0, warps in subs:
                        kt, vt = rows(k[b, :, hk], k0, SUB_Q), rows(v[b, :, hk], k0, SUB_Q)
                        for w, masked in enumerate(warps):
                            if masked is None:
                                continue
                            r = slice(16 * w, 16 * w + 16)
                            zero = np.zeros((16, SUB_Q), f32)
                            s = _product(zero, qt[r], kt.T, nt, **arith)
                            dp = _product(zero, gt[r], vt.T, nt, **arith)
                            p = probs(s, lse_t[r, None], q0 + np.arange(r.start, r.stop),
                                      k0 + np.arange(SUB_Q), False)
                            ds = (p * (dp - d_t[r, None])).astype(f32)
                            acc[r] = _product(acc[r], ds, kt, _ksteps(SUB_Q, False), **arith)
                n = min(OWN, S - q0)
                dq[b, q0:q0 + n, h] = acc[:n] * scale
    return dq, dk, dv


CASES = [  # B, S, H, Hkv, dh, causal
    (1, 130, 4, 2, 32, True),  # ragged, GQA
    (2, 45, 2, 2, 80, True),  # one tile, ragged
    (1, 130, 2, 2, 80, False),  # full
    (1, 150, 4, 1, 16, True),  # a group of 4, two k-steps
    (1, 45, 4, 4, 16, False),
    (1, 130, 8, 1, 128, True),  # a group of 8, 32-row steps
    (1, 256, 2, 2, 64, True),  # whole tiles
]


def _inputs(B, S, H, Hkv, dh, causal, seed=0):
    """f32 inputs, o and lse from the plain forward."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(B, S, H, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, S, Hkv, dh)).astype(np.float32) for _ in range(2))
    o, lse = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                                     return_lse=True)
    return q, k, v, o.numpy(), lse.numpy(), do


def _plain(q, k, v, o, lse, do, causal):
    return [x.numpy() for x in ref.flash_attention_backward_ref(
        *(torch.from_numpy(x) for x in (q, k, v, o, lse, do)), causal)]


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,Hkv,dh,causal", CASES)
def test_model_matches_the_plain_version(B, S, H, Hkv, dh, causal):
    args = _inputs(B, S, H, Hkv, dh, causal)
    got = model_backward(*args, causal)
    want = _plain(*args, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)


def test_sums_apart_survive_a_truncating_accumulator():
    """Why each k-step's terms are summed apart (``add4``): with the tensor
    core's additions modelled as truncation toward zero, a dK and dV summed
    in the mma across a key tile's 2,400 query rows (8 heads of 300) drift
    past 2e-5, as the card's did (1.245e-4 there, 1.08e-4 here); summed
    apart a k-step at a time they meet it."""
    args = _inputs(1, 300, 8, 1, 64, True)
    want = _plain(*args, True)
    got = model_backward(*args, True, truncate=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)
    chained = model_backward(*args, True, truncate=True, apart=False)
    for name, g, w in zip(("dk", "dv"), chained[1:], want[1:]):
        with pytest.raises(AssertionError):
            _close(g, w, name)


def test_one_tf32_product_is_not_enough():
    """One tf32 product a pair (the split's small parts dropped) misses the
    tolerance that three meet: the reason for 3xTF32."""
    args = _inputs(1, 130, 2, 2, 80, True)
    got = model_backward(*args, True, products=1)
    want = _plain(*args, True)
    with pytest.raises(AssertionError):
        _close(got[1], want[1], "dk")


@pytest.mark.parametrize("dh", [32, 128])
def test_planted_late_start_is_caught(dh):
    """The planted fault (every dK/dV loop one query tile late) fails the
    check on dk and dv; dq, from the other pass, still matches."""
    args = _inputs(1, 200, 2, 1, dh, True, seed=1)
    got = model_backward(*args, True, late=1)
    want = _plain(*args, True)
    _close(got[0], want[0], "dq")
    for name, g, w in zip(("dk", "dv"), got[1:], want[1:]):
        with pytest.raises(AssertionError):
            _close(g, w, name)
