"""K6's bf16 kernel as a persistent launch (csrc/flash_attention.cu), on the
CPU, where no CUDA kernel runs.

* The tile walk: ``Walk`` is plain host-and-device C++; its text is taken
  from the source and compiled here with g++ beside a driver that prints
  every CTA's work tiles, which must equal ``kernels.flash_attention.k6_walk``
  (the twin that the tests and tools read) over causal and full attention,
  ragged S and CTA counts 1, 7 and 132.  Every tile is visited once, and
  causal tiles are taken heaviest-first: each unit costs no more KV tiles
  than the one a CTA took before it, and a pair takes its heavier q-tile
  first.  The kernel's loops and grid, which the driver mirrors, are read
  from the source.
* The tensor maps: ``tensor_map.cuh`` compiled with g++ against stub CUDA
  headers whose driver functions record what they are asked: a map is
  encoded once for a shape, strides and box, a later call with a new
  pointer gets a copy with its own address (bit-equal to a fresh encode),
  other strides or another box encode anew, the oldest of the cache's maps
  goes first, and without ``cuTensorMapReplaceAddress`` every call encodes.
* The wrapper: two calls with new tensors pass their own pointers and the
  same C interface as before.
"""
import contextlib
import re
import shutil
import subprocess
import types

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as K6

FWD = (build.CSRC / f"{K6.NAME}.cu").read_text()
MAPS = (build.CSRC / "tensor_map.cuh").read_text()
GXX = shutil.which("g++") or "g++"


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", FWD).group(1))


def _body(src: str, head: str) -> str:
    start = src.index(head)
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start:j + 1]
    raise AssertionError(head)


def _compile(tmp, name: str, code: str, *flags: str):
    cpp = tmp / f"{name}.cpp"
    cpp.write_text(code)
    exe = tmp / name
    subprocess.run([GXX, "-std=c++17", "-O1", *flags, "-o", str(exe), str(cpp)], check=True,
                   capture_output=True, text=True)
    return exe


# ------------------------------------------------------------------ the walk

WALK_DRIVER = r"""
#include <cstdio>
#define __host__
#define __device__
constexpr int kRowsCta = %(rows)d;
%(walk)s
int main() {
  long long B, S;
  int H, ctas, causal;
  while (std::scanf("%%lld %%lld %%d %%d %%d", &B, &S, &H, &ctas, &causal) == 5) {
    const Walk walk(B, S, H, causal);
    const long long units = walk.units();
    const long long grid = units < ctas ? units : ctas;  // launch_bf16's grid
    for (long long c = 0; c < grid; ++c) {
      for (long long u = c; u < units; u += grid)  // the kernel's loops, blockIdx.x = c
        for (int t = 0; t < walk.tiles(u); ++t) {
          int b, h, qt;
          walk.tile(u, t, b, h, qt);
          std::printf("%%lld %%d %%d %%d %%lld\n", c, b, h, qt, u);
        }
    }
    std::printf("end\n");
  }
}
"""

CASES = [(B, S, H, ctas, causal) for S in (1, 127, 128, 129, 1000, 4096)
         for ctas in (1, 7, 132) for causal in (True, False) for B, H in ((2, 3),)]
CASES += [(256, 128, 8, 132, True), (4, 4096, 32, 132, True), (1, 4096, 16, 132, True)]


def test_walk_constants_and_loops_match_the_source():
    """The twin's tile is the kernel's (kBQ rows a warpgroup, kConsumers
    warpgroups); producer and consumers walk the same units, the grid is
    the smaller of the units and the SMs' CTAs."""
    assert K6.ROWS_CTA == _const("kBQ") * _const("kConsumers") == _const("kBKV")
    assert "constexpr int kRowsCta = kBQ * kConsumers;" in FWD
    kernel = _body(FWD, "flash_attention_bf16_kernel(const __grid_constant__")
    assert kernel.count("const long long n_units = walk.units();") == 1
    producer = _body(kernel, "if (wg == kConsumers) {")
    assert "for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {" in producer
    assert "for (int t = 0; t < walk.tiles(u); ++t, ++qi) {" in producer
    consumers = kernel[kernel.index(producer) + len(producer):]
    for line in ("long long u = blockIdx.x;", "int t = 0;", "if (u >= n_units) return false;",
                 "if (++t == walk.tiles(u)) t = 0, u += gridDim.x;"):
        assert line in consumers, line
    assert kernel.count("walk.tile(u, t, b, h, qt);") == 2
    launch = _body(FWD, "int launch_bf16(")
    assert "const Walk walk(B, S, H, causal);" in launch
    assert "const long long ctas = (long long)sm_count() * kCtasPerSm;" in launch
    assert "const dim3 grid((unsigned)(walk.units() < ctas ? walk.units() : ctas));" in launch
    assert _const("kCtasPerSm") == 1 and "__launch_bounds__(kThreadsBf16, 1)" in FWD


@pytest.fixture(scope="module")
def walk_exe(tmp_path_factory):
    code = WALK_DRIVER % {"rows": _const("kBQ") * _const("kConsumers"),
                          "walk": _body(FWD, "struct Walk {") + ";"}
    return _compile(tmp_path_factory.mktemp("walk"), "walk", code)


def _source_walks(exe, cases):
    stdin = "".join(f"{B} {S} {H} {c} {int(causal)}\n" for B, S, H, c, causal in cases)
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True,
                         check=True).stdout
    walks, cur = [], {}
    for line in out.splitlines():
        if line == "end":
            walks.append(cur)
            cur = {}
            continue
        c, b, h, qt, u = map(int, line.split())
        cur.setdefault(c, []).append((b, h, qt, u))
    return walks


def _kv_tiles(S, qt, causal):
    end = min((qt + 1) * K6.ROWS_CTA, S) if causal else S
    return -(-end // 128)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_walk_twin_matches_the_source(walk_exe, case):
    """The source's walk, compiled, and the twin give every CTA the same
    tiles in the same order; each (b, h, q-tile) once; a CTA's units cost
    no more KV tiles than the one before (causal: pairs of n + 1, then the
    middle tiles), and a pair takes its heavier q-tile first."""
    B, S, H, ctas, causal = case
    (got,) = _source_walks(walk_exe, [case])
    twin = K6.k6_walk(B, S, H, ctas, causal)
    assert [[t[:3] for t in got[c]] for c in range(len(got))] == twin
    n_qt = -(-S // K6.ROWS_CTA)
    seen = sorted(t for cta in twin for t in cta)
    assert seen == [(b, h, q) for b in range(B) for h in range(H) for q in range(n_qt)]
    assert len(twin) == min(ctas, B * H * (n_qt - n_qt // 2 if causal else n_qt))
    for c, tiles in got.items():
        units = {}
        for b, h, qt, u in tiles:
            units.setdefault(u, []).append(_kv_tiles(S, qt, causal))
        costs = [sum(ks) for ks in units.values()]
        assert costs == sorted(costs, reverse=True), (c, costs)
        assert all(ks == sorted(ks, reverse=True) for ks in units.values())
        assert list(units) == sorted(units)


UNIT_DRIVER = r"""
#include <cstdio>
#define __host__
#define __device__
constexpr int kRowsCta = %(rows)d;
%(walk)s
int main() {
  long long B, S, u;
  int H, causal;
  while (std::scanf("%%lld %%lld %%d %%d %%lld", &B, &S, &H, &causal, &u) == 5) {
    const Walk walk(B, S, H, causal);
    for (int t = 0; t < walk.tiles(u); ++t) {
      int b, h, qt;
      walk.tile(u, t, b, h, qt);
      std::printf("%%d %%d %%d\n", b, h, qt);
    }
    std::printf("end %%lld\n", walk.units());
  }
}
"""


def test_walk_units_past_32_bits(tmp_path):
    """Launches of 2^31 units and more take the walk's 64-bit arithmetic:
    units on both sides of the switch, and the last, against the twin."""
    code = UNIT_DRIVER % {"rows": _const("kBQ") * _const("kConsumers"),
                          "walk": _body(FWD, "struct Walk {") + ";"}
    exe = _compile(tmp_path, "unit", code)
    cases = []
    for B, S, H, causal in ((2**16, 4096, 2**11, True), (2**20, 128, 2**11, True),
                            (2**20, 1000, 2**8, False), (3, 4096 * 2**10, 2**10, True)):
        units = K6.k6_units(B, S, H, causal)
        for u in sorted({0, 2**31 - 2, 2**31 - 1, min(2**31, units - 1), units - 1}):
            if u < units:
                cases.append((B, S, H, causal, u))
    stdin = "".join(f"{B} {S} {H} {int(c)} {u}\n" for B, S, H, c, u in cases)
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True,
                         check=True).stdout.split("end")
    assert any(K6.k6_units(*c[:4]) >= 2**31 for c in cases)
    for (B, S, H, causal, u), block in zip(cases, out):
        got = [tuple(map(int, ln.split())) for ln in block.strip().splitlines()
               if len(ln.split()) == 3]
        assert got == K6.k6_unit(B, S, H, causal, u), (B, S, H, causal, u)


def test_walk_pairs_cost_alike_at_stablelm_prefill():
    """Causal at [4, 4096, 32 heads] on 132 CTAs: 2,048 pairs of 33 KV
    tiles, so the CTAs' loads differ by at most one pair."""
    walk = K6.k6_walk(4, 4096, 32, 132, True)
    loads = [sum(_kv_tiles(4096, qt, True) for _, _, qt in cta) for cta in walk]
    assert len(walk) == 132 and max(loads) - min(loads) == 33
    assert sum(loads) == 4 * 32 * 32 * 33 // 2


# ------------------------------------------------------------ the map cache

STUB_CUDA = r"""
#pragma once
#include <stdint.h>
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_NOT_FOUND = 500 };
typedef struct alignas(64) { unsigned long long opaque[16]; } CUtensorMap;
typedef int CUtensorMapDataType; typedef int CUtensorMapInterleave;
typedef int CUtensorMapSwizzle; typedef int CUtensorMapL2promotion;
typedef int CUtensorMapFloatOOBfill;
enum { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9, CU_TENSOR_MAP_INTERLEAVE_NONE = 0,
       CU_TENSOR_MAP_SWIZZLE_32B = 1, CU_TENSOR_MAP_SWIZZLE_64B = 2,
       CU_TENSOR_MAP_SWIZZLE_128B = 3, CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2,
       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
typedef unsigned long long cuuint64_t;
typedef unsigned int cuuint32_t;
"""

STUB_RUNTIME = r"""
#pragma once
#include <string.h>
#include "cuda.h"
#define CUDART_VERSION 12080
typedef int cudaError_t;
enum { cudaSuccess = 0 };
typedef int cudaDriverEntryPointQueryResult;
enum { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
// The driver: encode packs the address and the map's arguments; replace
// writes the address.  Both count their calls.
inline int n_encode = 0, n_replace = 0;
inline CUresult fake_encode(CUtensorMap* m, CUtensorMapDataType dt, cuuint32_t rank, void* p,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box, const cuuint32_t* elem,
                            CUtensorMapInterleave il, CUtensorMapSwizzle sw,
                            CUtensorMapL2promotion l2, CUtensorMapFloatOOBfill oob) {
  ++n_encode;
  memset(m, 0, sizeof(*m));
  m->opaque[0] = (unsigned long long)p;
  for (int i = 0; i < 4; ++i) m->opaque[1 + i] = dims[i];
  for (int i = 0; i < 3; ++i) m->opaque[5 + i] = strides[i];
  for (int i = 0; i < 4; ++i) m->opaque[8 + i] = box[i];
  m->opaque[12] = (unsigned long long)sw;
  m->opaque[13] = (unsigned long long)dt + 16 * rank;
  return CUDA_SUCCESS;
}
inline CUresult fake_replace(CUtensorMap* m, void* p) {
  ++n_replace;
  m->opaque[0] = (unsigned long long)p;
  return CUDA_SUCCESS;
}
inline cudaError_t cudaGetDriverEntryPointByVersion(const char* name, void** p, unsigned,
                                                    int, cudaDriverEntryPointQueryResult* q) {
  *p = nullptr;
  if (!strcmp(name, "cuTensorMapEncodeTiled")) *p = (void*)fake_encode;
#ifndef NO_REPLACE
  if (!strcmp(name, "cuTensorMapReplaceAddress")) *p = (void*)fake_replace;
#endif
  *q = *p ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}
"""

MAP_DRIVER = r"""
#include <cstdio>
#include <cstring>
#include "tensor_map.cuh"
using namespace tensor_map;
static char buf[1 << 16];
int map(CUtensorMap* m, int at, long long ss, int cols) {
  return make_map(m, buf + 16 * at, 2, 4096, 32, 80, 4096LL * 32 * 80, ss, 80, cols, 128);
}
int main() {
  CUtensorMap a, b, fresh;
  int err = map(&a, 1, 32 * 80, 64);
  std::printf("first %d %d %d\n", err, n_encode, n_replace);
  err = map(&b, 2, 32 * 80, 64);  // a new pointer, the same shape
  std::printf("second %d %d %d %d\n", err, n_encode, n_replace,
              (int)(b.opaque[0] == (unsigned long long)(buf + 32)));
  encode_map(&fresh, buf + 32, 2, 4096, 32, 80, 4096LL * 32 * 80, 32 * 80, 80, 64, 128);
  std::printf("fresh %d\n", (int)!std::memcmp(&fresh, &b, sizeof(b)));
  int before = n_encode;
  map(&b, 3, 33 * 80, 64);  // other strides
  map(&b, 3, 32 * 80, 16);  // another box
  std::printf("others %d\n", n_encode - before);
  before = n_encode;
  for (int i = 0; i < kCached; ++i) map(&b, 4, 64 * 80 + 8 * i, 64);  // evicts the first three
  map(&b, 5, 32 * 80, 64);
  std::printf("evicted %d %d\n", n_encode - before, kCached);
}
"""


@pytest.fixture(scope="module")
def map_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("maps")
    (tmp / "cuda.h").write_text(STUB_CUDA)
    (tmp / "cuda_runtime.h").write_text(STUB_RUNTIME)

    def run(*flags):
        exe = _compile(tmp, "maps" + "".join(f.strip("-") for f in flags), MAP_DRIVER,
                       "-I", str(tmp), "-I", str(build.CSRC), *flags)
        out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
        return {ln.split()[0]: [int(x) for x in ln.split()[1:]] for ln in out.splitlines()}

    return run


def test_map_cache_replaces_the_address(map_run):
    """Encoded once a shape; a new pointer's map is the old one with its own
    address, bit-equal to a fresh encode; other strides and another box
    encode; past kCached maps the oldest is encoded again."""
    got = map_run()
    assert got["first"] == [0, 1, 0]
    assert got["second"] == [0, 1, 1, 1]
    assert got["fresh"] == [1]
    assert got["others"] == [2]
    assert got["evicted"][0] == got["evicted"][1] + 1


def test_map_cache_without_replace_encodes_every_call(map_run):
    """A driver without cuTensorMapReplaceAddress: no cache, each call encodes."""
    got = map_run("-DNO_REPLACE")
    assert got["first"] == [0, 1, 0]
    assert got["second"] == [0, 2, 0, 1]
    assert got["fresh"] == [1]


def test_make_map_is_the_only_map_path_of_the_launches():
    """Both kernels' launches build their maps through the cached
    ``make_map``; only the host-time probe calls ``encode_map`` itself."""
    bwd = (build.CSRC / f"{K6.NAME_BWD}.cu").read_text()
    assert "encode_map" not in bwd and "make_map(" in bwd
    launch = _body(FWD, "int launch_bf16(")
    assert "make_maps_bf16<D>(" in launch and "encode_map" not in launch
    assert "cuTensorMapReplaceAddress" in MAPS


# ---------------------------------------------------------------- the wrapper


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, sym):
        if not sym.startswith(K6.NAME):
            raise AttributeError(sym)
        return lambda *args: self.calls.append((sym, args)) or 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(K6, "_on_cuda", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=7))
    before = (K6.launches, K6.launches_f32)
    yield lib
    K6.launches, K6.launches_f32 = before


def test_wrapper_passes_each_calls_own_pointers(fake_lib):
    """Two bf16 calls on new tensors of one shape: each launch gets its own
    q, k, v, output and logsumexp addresses (the maps are cached in the
    library by shape alone), through the C interface the source exports."""
    B, S, H, Hkv, dh = 2, 40, 4, 2, 32
    calls = []
    for _ in range(2):
        q = torch.zeros(B, S, H, dh, dtype=torch.bfloat16)
        k, v = (torch.zeros(B, S, Hkv, dh, dtype=torch.bfloat16) for _ in "kv")
        lse = torch.empty(B, H, S)
        out = K6.flash_attention(q, k, v, True, lse=lse)
        calls.append(((q, k, v, out, lse), fake_lib.calls[-1]))
    for (q, k, v, out, lse), (sym, a) in calls:
        assert sym == "flash_attention_bf16" and len(a) == len(K6._ARGS) == 13
        assert a[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        assert a[12] == lse.data_ptr() and a[11] == 7
    assert calls[0][1][1][0] != calls[1][1][1][0]
    params = _body(FWD, "int flash_attention_bf16(const void* q").split("{")[0]
    assert params.count(",") + 1 == len(K6._ARGS)
