"""The bf16 tiles of K6 (csrc/flash_attention.cu) and K6'
(csrc/flash_attention_backward.cu) in shared memory, modelled in numpy on
the CPU, where no CUDA kernel runs.

A tile is TMA-loaded as regions, one box each, whose rows are 32, 64 or 128
bytes and swizzled over that span: the 16-byte chunk bits (4 and up) of
each byte address XOR the bits from 7 up (CUTLASS's ``Swizzle<B, 4, 3>``,
B = 1, 2, 3), on the absolute shared-memory address.  A wgmma descriptor
(start, LBO, SBO, swizzle) reads the same memory through the canonical
layouts: K-major, element (row m, column k) of a k-step at ``start + (m %
8) span + (m / 8) SBO + 2 k``; MN-major (the transpose bit), element
(column n, row k) at ``start + 2 (n % (span / 2)) + (n / (span / 2)) LBO +
(k % 8) span + (k / 8) SBO``, each then swizzled.  The model places every
box where the producer's ``tma_load_4d`` puts it, evaluates every
descriptor's arguments as the source writes them (the expressions are read
from the source and evaluated here), and checks that each address a
k-step's descriptor reads holds the element the product needs: the tile's
columns 16c.. for a K-major k-step c, its rows 16kk.. for an MN-major
k-step kk, and that the products' columns cover dh once, in the order of
the accumulator's registers.  The region plan (``Layout<D>`` and
``TileBf16<D>``: regions of 64 columns, the remainder, the 16-column
chunks) is read from the source too, at every bf16 head dim the wrappers
take; the plan before head dims 16 and 32 were taken (dh 16 read as dh
80's chunked V in K6, as a 64-byte remainder in K6') fails the check.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as K6

FWD = (build.CSRC / f"{K6.NAME}.cu").read_text()
BWD = (build.CSRC / f"{K6.NAME_BWD}.cu").read_text()
DIMS = K6.HEAD_DIMS[torch.bfloat16]


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _py(expr: str) -> str:
    """A C++ integer expression of the sources as Python."""
    expr = re.sub(r"\b(Ly|T)::(\w+)", r"\1_\2", expr)
    expr = expr.replace("||", " or ").replace("&&", " and ").replace("/", "//")
    m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", expr)
    return f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))" if m else expr


def _eval(expr: str, ns: dict):
    return eval(_py(expr), {"__builtins__": {}}, dict(ns))


def _body(src: str, head: str) -> str:
    """The text of the function (or struct) whose declaration holds ``head``."""
    start = src.index(head)
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start:j + 1]
    raise AssertionError(head)


def _args(text: str, call: str) -> list[list[str]]:
    """The top-level arguments of every call in ``text`` whose name matches
    the pattern ``call``, in order."""
    out = []
    for m in re.finditer(call + r"\(", text):
        i, depth, args, cur = m.end(), 1, [], ""
        while depth:
            ch = text[i]
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if (ch == "," and depth == 1) or depth == 0:
                args.append(" ".join(cur.split()))
                cur = ""
            else:
                cur += ch
            i += 1
        out.append(args)
    return out


def _descs(text: str) -> list[tuple[str, list[str]]]:
    """(swizzle span, [start, LBO, SBO]) of every ``hopper::desc<...>`` in order."""
    spans = re.findall(r"hopper::desc<(\w+)>\(", text)
    return list(zip(spans, _args(text, r"hopper::desc<\w+>")))


def _locals(text: str) -> list[tuple[str, str]]:
    return re.findall(r"(?:const uint32_t|constexpr int) (\w+) = ([^;]+);", text)


def _plan(src: str, struct: str, D: int, prefix: str, overrides: dict | None = None) -> dict:
    """The struct's ``static constexpr`` members at head dim D, over the
    file's integer constants (``overrides`` replaces a member's expression)."""
    ns = {name: int(v) for name, v in re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)}
    ns["D"] = D
    for name, expr in re.findall(r"static constexpr (?:int|bool) (\w+) = ([^;]+);", struct):
        expr = (overrides or {}).get(name, expr)
        ns[f"{prefix}_{name}"] = ns[name] = _eval(expr, ns)
    return ns


# ------------------------------------------------------------------ swizzle


def swizzle(addr, span: int):
    """The byte address after the swizzle of ``span`` bytes (32, 64, 128)."""
    return addr ^ (((addr >> 7) & (span // 16 - 1)) << 4)


@pytest.mark.parametrize("span", [32, 64, 128])
def test_swizzle_permutes_chunks_within_its_atom(span):
    """Each swizzle moves 16-byte chunks within a row of ``span`` bytes
    (bits 0-3 kept), is a bijection of its atom of 8 rows of 128 bytes'
    worth, and repeats every 1024 bytes: a box base on a multiple of the
    atom (256, 512, 1024 bytes) sees the pattern from its first row."""
    a = np.arange(4096)
    s = swizzle(a, span)
    assert (s & 15 == a & 15).all() and (s // span == a // span).all()
    atom = 8 * span
    for base in range(0, 4096, atom):
        assert sorted(s[base:base + atom]) == list(range(base, base + atom))
    rows = np.arange(8 * 128 // span)
    chunk = (swizzle(rows * span, span) % span) // 16  # chunk 0 of each row of 1024 bytes
    assert sorted(set(chunk)) == list(range(span // 16))


class Smem:
    """Shared memory as the label of each bf16 element: (tile, row, column)."""

    def __init__(self):
        self.cell: dict[int, tuple] = {}

    def box(self, tile: str, dst: int, rows: int, col0: int, cols: int) -> None:
        span = 2 * cols
        assert span in (32, 64, 128) and dst % (8 * span) == 0, (tile, dst, span)
        for r in range(rows):
            for c in range(cols):
                a = int(swizzle(dst + r * span + 2 * c, span))
                assert a not in self.cell, f"{tile}: boxes overlap at {a}"
                self.cell[a] = (tile, r, col0 + c)

    def holds(self, tile: str, rows: int, D: int) -> None:
        got = {v for v in self.cell.values() if v[0] == tile}
        assert got == {(tile, r, c) for r in range(rows) for c in range(D)}, tile


def read_kmajor(mem, desc, span: int, rows: int):
    """Labels a K-major k-step reads: [rows][16]."""
    start, _, sbo = desc
    return [[mem.cell.get(int(swizzle(start + (m % 8) * span + (m // 8) * sbo + 2 * k, span)))
             for k in range(16)] for m in range(rows)]


def read_mnmajor(mem, desc, span: int, n: int):
    """Labels an MN-major k-step reads: [16][n]."""
    start, lbo, sbo = desc
    per = span // 2
    return [[mem.cell.get(int(swizzle(start + 2 * (j % per) + (j // per) * lbo
                                      + (k % 8) * span + (k // 8) * sbo, span)))
             for j in range(n)] for k in range(16)]


def _want_k(tile, row0, rows, c):
    return [[(tile, row0 + m, 16 * c + k) for k in range(16)] for m in range(rows)]


def _want_mn(tile, kk, col0, n):
    return [[(tile, 16 * kk + k, col0 + j) for j in range(n)] for k in range(16)]


# -------------------------------------------------------------------- K6


BQ, BKV, CONSUMERS = _const(FWD, "kBQ"), _const(FWD, "kBKV"), _const(FWD, "kConsumers")
SMEM_LIMIT = 232_448  # bytes of shared memory a block of an H100 may take


def k6_model(D: int, overrides: dict | None = None) -> None:
    """K6's loads and S / P . V descriptors at head dim D; raises where a
    descriptor reads anything but what its product needs."""
    ly = _plan(FWD, _body(FWD, "struct Layout {"), D, "Ly", overrides)
    kernel = _body(FWD, "flash_attention_bf16_kernel(const __grid_constant__")
    launch = _body(FWD, "int make_maps_bf16(")
    # the maps the launch builds: [0] of 64 columns from kMain on, [1] of kRem
    # (16 for a chunked V)
    first = _eval(re.search(r"for \(int j = (Layout<D>::kMain \? 0 : 1);", launch).group(1)
                  .replace("Layout<D>::", "Ly::"), ly)
    assert "const int cols = j == 0 ? 64 : kRem;" in launch
    assert "j == 1 && Layout<D>::kVChunked ? 16 : cols" in launch
    built = set(range(first, 2 if ly["kRem"] else 1))
    width = {0: 64, 1: ly["kRem"]}
    assert "if (Ly::kVChunked) {" in kernel  # V in 16-column boxes, else as Q and K
    load = _body(kernel, "auto load = [&]")
    (main, rem) = _args(load, r"hopper::tma_load_4d")
    assert (main[1], rem[1]) == ("&m[0]", "&m[1]")
    mem, used = Smem(), set()

    def tile(name, dst, rows, v=False):
        for j in range(0 if v and ly["kVChunked"] else ly["kMain"]):
            ns = dict(ly, dst=dst, rows=rows, j=j)
            mem.box(name, _eval(main[0], ns), rows, _eval(main[3], ns), width[0])
            used.add(0)
        if ly["kRem"] and not (v and ly["kVChunked"]):
            ns = dict(ly, dst=dst, rows=rows)
            mem.box(name, _eval(rem[0], ns), rows, _eval(rem[3], ns), width[1])
            used.add(1)
        if v and ly["kVChunked"]:
            (ch,) = _args(kernel, r"hopper::tma_load_4d(?=\(v_dst)")
            for c in range(D // 16):
                ns = dict(ly, v_dst=dst, c=c)
                mem.box(name, _eval(ch[0], ns), rows, _eval(ch[3], ns), 16)
            used.add(1)

    # Every Q buffer (a warpgroup's half each) and every stage of the K/V
    # ring, where the producer's loads put them
    qbytes, qtile, kvbytes = ly["kQBytes"], ly["kQTile"], ly["kKVBytes"]
    assert qbytes == BQ * D * 2 and kvbytes == BKV * D * 2 and qtile == CONSUMERS * qbytes
    producer = _body(kernel, "if (wg == kConsumers) {")
    (q_dst,) = (a[0] for a in _args(producer, r"\bload") if a[1] == "maps.q")
    (k_dst,) = (a[0] for a in _args(producer, r"\bload") if a[1] == "maps.k")
    v_dst = re.search(r"uint8_t\* v_dst = ([^;]+);", producer).group(1)
    q_at = {(qb, w): _eval(q_dst.replace("smem + ", ""), dict(ly, qb=qb, w=w))
            for qb in range(ly["kQBufs"]) for w in range(CONSUMERS)}
    k_at = {s: _eval(k_dst.replace("smem + ", ""), dict(ly, s=s)) for s in range(ly["kStages"])}
    v_at = {s: _eval(v_dst.replace("smem + ", ""), dict(ly, s=s)) for s in range(ly["kStages"])}
    for (qb, w), at in q_at.items():
        tile(f"q{qb}.{w}", at, BQ)
    for s_ in range(ly["kStages"]):
        tile(f"k{s_}", k_at[s_], BKV)
        tile(f"v{s_}", v_at[s_], BKV, v=True)
    assert used <= built, f"a box of a map the launch does not build: {used - built}"
    for (qb, w) in q_at:
        mem.holds(f"q{qb}.{w}", BQ, D)
    for s_ in range(ly["kStages"]):
        mem.holds(f"k{s_}", BKV, D)
        mem.holds(f"v{s_}", BKV, D)
    top = max(mem.cell) + 1
    assert top <= ly["kBar"], f"tiles reach byte {top}, past the barriers at {ly['kBar']}"
    assert ly["kBytes"] <= SMEM_LIMIT, f"{ly['kBytes']} bytes of shared memory at dh {D}"

    qk = _body(FWD, "void issue_qk(")
    d = _descs(qk)
    lcl = _locals(qk)
    for (qb, w), q_addr in q_at.items():
        for s_, k_addr in k_at.items():
            for c in range(D // 16):
                ns = dict(ly, c=c, q_addr=q_addr, k_addr=k_addr, kBQ=BQ, kBKV=BKV)
                for name, expr in lcl:
                    ns[name] = _eval(expr, ns)
                pair = d[0:2] if c < 4 * ly["kMain"] else d[2:4]
                (sa, a), (sb, b) = pair
                da, db = ([_eval(x, ns) for x in args] for args in (a, b))
                span = _eval(sa, ns)
                assert read_kmajor(mem, da, span, 64) == _want_k(f"q{qb}.{w}", 0, 64, c), \
                    (D, "Q", qb, w, c)
                assert read_kmajor(mem, db, _eval(sb, ns), BKV) == _want_k(f"k{s_}", 0, BKV, c), \
                    (D, s_, c)

    pv = _body(FWD, "void issue_pv(")
    d = _descs(pv)
    n_of = [int(n) for n in re.findall(r"wgmma_rs_m64n(\d+)<", pv)]
    span_rem = ly["kRem"] * 2
    for s_, kk in ((s_, kk) for s_ in v_at for kk in range(BKV // 16)):
        products = []  # (descriptor, swizzle span, n, first column)
        ns = dict(ly, kk=kk, v_addr=v_at[s_], kBKV=BKV, span=span_rem)
        ns["v_rem"] = _eval(re.search(r"const uint32_t v_rem = ([^;]+);", pv).group(1), ns)
        if ly["kVChunked"]:
            products.append((d[0], n_of[0], 0))
        else:
            for j in range(ly["kMain"]):
                products.append((d[1], n_of[1], 64 * j, {"j": j}))
            if ly["kRem"]:
                k = 2 if ly["kRem"] == 16 else 3
                products.append((d[k], n_of[k], 64 * ly["kMain"]))
        cols = []
        for p in products:
            (sw, args), n, col0 = p[:3]
            ns_p = dict(ns, **(p[3] if len(p) > 3 else {}))
            desc = [_eval(x, ns_p) for x in args]
            assert read_mnmajor(mem, desc, _eval(sw, ns_p), n) == \
                _want_mn(f"v{s_}", kk, col0, n), (D, "V", s_, kk, col0)
            cols += range(col0, col0 + n)
        assert cols == list(range(D)), f"P . V's products cover columns {cols[:3]}.. of {D}"


@pytest.mark.parametrize("dh", DIMS)
def test_k6_descriptors_find_the_boxes(dh):
    k6_model(dh)


def test_k6_old_plan_is_caught():
    """dh 16 with V chunked as dh 80's (the plan when bf16 refused it)."""
    k6_model(80, {"kVChunked": "kRem == 16"})
    with pytest.raises(AssertionError):
        k6_model(16, {"kVChunked": "kRem == 16"})


# -------------------------------------------------------------------- K6'


OWN, QSTEP, KSTEP = (_const(BWD, n) for n in ("kOwnRows", "kQueryStep", "kKeyStep"))


def k6b_model(D: int, overrides: dict | None = None) -> None:
    """K6''s tiles (owned: 128 rows; streamed: 64) at head dim D: every
    K-major k-step of rows 0.. and 64.. (the two warpgroups' rows of an
    owned tile, the whole of a streamed one) and every MN-major k-step of a
    streamed tile (dV's dO, dK's Q, dQ's K)."""
    t = _plan(BWD, _body(BWD, "struct TileBf16 {"), D, "T", overrides)
    maps = _body(BWD, "int make_maps(")
    args = "p, B, S, heads, D, sb, ss, sh"
    assert f"if constexpr (T::kChunked) return make_map(&m[1], {args}, 16, rows);" in maps
    assert f"T::kMain ? make_map(&m[0], {args}, 64, rows) : 0" in maps
    assert f"if (!err && T::kRem) err = make_map(&m[1], {args}, T::kRem, rows);" in maps
    built = {1: 16} if t["kChunked"] else {**({0: 64} if t["kMain"] else {}),
                                           **({1: t["kRem"]} if t["kRem"] else {})}
    tt = _body(BWD, "void tma_tile(")
    chunk, main, rem = _args(tt, r"hopper::tma_load_4d")
    mem = Smem()

    def tile(name, dst, R):
        boxes = []
        if t["kChunked"]:
            boxes += [(chunk, dict(t, c=c)) for c in range(D // 16)]
        else:
            boxes += [(main, dict(t, j=j)) for j in range(t["kMain"])]
            if t["kRem"] > 0:
                boxes.append((rem, dict(t)))
        for args, ns in boxes:
            m = int(args[1][3])
            assert m in built, f"{name}: a box of map [{m}], which make_maps does not build"
            ns = dict(ns, dst=dst, R=R)
            mem.box(name, _eval(args[0], ns), R, _eval(args[3], ns), built[m])
        mem.holds(name, R, D)

    own, step = OWN * D * 2, QSTEP * D * 2
    tile("own", 0, OWN)
    tile("step", own, QSTEP)
    kd = _body(BWD, "uint64_t kmajor_desc(")
    d = _descs(kd)
    for name, base, R, rows0 in (("own", 0, OWN, (0, 64)), ("step", own, QSTEP, (0,))):
        for row0 in rows0:
            for c in range(D // 16):
                ns = dict(t, tile=base, R=R, row0=row0, c=c)
                k = 0 if t["kChunked"] else (1 if c < 4 * t["kMain"] else 2)
                sw, args = d[k]
                desc = [_eval(x, ns) for x in args]
                assert read_kmajor(mem, desc, int(sw), 64) == _want_k(name, row0, 64, c), \
                    (D, name, row0, c)
    rs = _body(BWD, "void rs_step(")
    d = _descs(rs)
    n_of = [int(n) for n in re.findall(r"wgmma_rs_m64n(\d+)<", rs)]
    assert "if constexpr (D == 80) hopper::wgmma_rs_m64n80<1>(acc, a, b);" in rs
    for kk in range(QSTEP // 16):
        ns = dict(t, y=own, K=QSTEP, kk=kk)
        if t["kChunked"]:
            products = [(d[0], n_of[0] if D == 80 else n_of[1], 0, {})]
        else:
            products = [(d[1], n_of[2], 64 * j, {"j": j}) for j in range(t["kMain"])]
            if t["kRem"] == 32:
                products.append((d[2], n_of[3], 64 * t["kMain"], {}))
        cols = []
        for (sw, args), n, col0, extra in products:
            desc = [_eval(x, dict(ns, **extra)) for x in args]
            assert read_mnmajor(mem, desc, int(sw), n) == _want_mn("step", kk, col0, n), \
                (D, kk, col0)
            cols += range(col0, col0 + n)
        assert cols == list(range(D)), f"the products cover columns {cols[:3]}.. of {D}"


@pytest.mark.parametrize("dh", DIMS)
def test_k6b_descriptors_find_the_boxes(dh):
    k6b_model(dh)


def test_k6b_old_plan_is_caught():
    """dh 16 outside the chunked layout (the plan when bf16 refused it): a
    16-column remainder read through dh 96's 64-byte descriptors."""
    k6b_model(80, {"kChunked": "D == 80"})
    with pytest.raises(AssertionError):
        k6b_model(16, {"kChunked": "D == 80"})
