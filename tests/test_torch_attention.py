"""repro_torch kernels K6 (flash attention) and K7 (flash decode): the plain
versions against the JAX package's Pallas kernels in interpret mode, over the
sweeps of tests/test_kernels.py, and against the model-path attention of
``repro.models.layers`` at stablelm-3b's head dim of 80.

On the CPU the port's entry points take the plain versions
(kernels/ref.py); the CUDA kernels themselves are held against those plain
versions on the card by chip_smoke.py.  Tolerances are the reference's own:
f32 2e-5, bf16 3e-2 (both sides round the bf16 inputs alike but sum in
different orders and round p at different points).
"""
import contextlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_decode import flash_decode as jax_decode
from repro.models.layers import flash_decode_shard as jax_decode_shard
from repro.models.layers import gqa_prefill_attention as jax_prefill_attention
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as K6
from repro_torch.kernels import flash_decode as K7
from repro_torch.models import layers as L

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _pair(a: np.ndarray, jdt, tdt):
    """The same numpy values as a jax array and a torch tensor of one dtype
    (both round f32 -> bf16 to nearest even)."""
    a32 = np.asarray(a, np.float32)
    return jnp.asarray(a32, jdt), torch.from_numpy(a32).to(tdt)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _tol(tdt) -> float:
    return 2e-5 if tdt == torch.float32 else 3e-2


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,S,H,Hkv,dh,causal,bq,bk",
    [
        (2, 64, 4, 2, 16, True, 32, 32),
        (1, 128, 4, 4, 32, False, 64, 32),
        (2, 64, 8, 2, 64, True, 16, 64),
        (1, 256, 2, 1, 128, True, 128, 128),
    ],
)
def test_flash_attention_matches_pallas(dtypes, B, S, H, Hkv, dh, causal, bq, bk, rng):
    jdt, tdt = dtypes
    q_j, q_t = _pair(rng.normal(size=(B, S, H, dh)), jdt, tdt)
    k_j, k_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    v_j, v_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    want = jax_flash(q_j, k_j, v_j, causal=causal, block_q=bq, block_k=bk,
                     interpret=True)
    got = ops.flash_attention(q_t, k_t, v_t, causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, H, dh)
    _close(got, want, _tol(tdt))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_matches_model_attention_dh80_ragged(dtypes, causal, rng):
    """stablelm-3b's dh = 80, GQA, and S = 45 that no q_block of 16 divides:
    the plain version, chunked by 16 and whole, and the port's
    ``layers.gqa_prefill_attention`` against the reference's."""
    jdt, tdt = dtypes
    B, S, H, Hkv, dh = 2, 45, 4, 2, 80
    q_j, q_t = _pair(rng.normal(size=(B, S, H, dh)), jdt, tdt)
    k_j, k_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    v_j, v_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    # The reference's XLA path takes KV repeated to H (transformer.py:219).
    want = jax_prefill_attention(q_j, jnp.repeat(k_j, H // Hkv, axis=2),
                                 jnp.repeat(v_j, H // Hkv, axis=2),
                                 causal=causal, q_block=16)
    _close(ref.flash_attention_ref(q_t, k_t, v_t, causal, q_block=16), want, _tol(tdt))
    _close(L.gqa_prefill_attention(q_t, k_t, v_t, causal=causal), want, _tol(tdt))


def test_flash_attention_chunking_does_not_change_the_result(rng):
    """The plain version's query chunk only bounds its memory."""
    q = torch.from_numpy(rng.normal(size=(1, 50, 2, 80)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 50, 1, 80)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 50, 1, 80)).astype(np.float32))
    whole = ref.flash_attention_ref(q, k, v, causal=True, q_block=64)
    for qb in (1, 7, 16):
        torch.testing.assert_close(ref.flash_attention_ref(q, k, v, True, qb), whole,
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- K7


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "B,S,H,Hkv,dh,L,bk",
    [(2, 128, 8, 2, 16, 100, 32), (1, 256, 4, 4, 32, 256, 64),
     (2, 64, 16, 2, 64, 1, 32), (1, 128, 2, 1, 128, 77, 128)],
)
def test_flash_decode_matches_pallas(dtypes, B, S, H, Hkv, dh, L, bk, rng):
    jdt, tdt = dtypes
    q_j, q_t = _pair(rng.normal(size=(B, H, dh)), jdt, tdt)
    k_j, k_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    v_j, v_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    want = jax_decode(q_j, k_j, v_j, jnp.asarray(L, jnp.int32), block_k=bk,
                      interpret=True)
    got = ops.flash_decode(q_t, k_t, v_t, torch.tensor(L, dtype=torch.int32))
    assert got.dtype == tdt and got.shape == (B, H, dh)
    _close(got, want, _tol(tdt))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("cache_len", [1, 37, 100])
def test_flash_decode_matches_model_decode_dh80(dtypes, cache_len, rng):
    """The plain version against ``layers.flash_decode_shard`` (one device)
    at S = 100, dh = 80, GQA groups of 4."""
    jdt, tdt = dtypes
    B, S, H, Hkv, dh = 2, 100, 8, 2, 80
    q_j, q_t = _pair(rng.normal(size=(B, H, dh)), jdt, tdt)
    k_j, k_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    v_j, v_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    want = jax_decode_shard(q_j, k_j, v_j, jnp.asarray(cache_len, jnp.int32),
                            jnp.zeros((), jnp.int32), combine_axes=())
    got = L.flash_decode_shard(q_t, k_t, v_t, torch.tensor(cache_len, dtype=torch.int32))
    _close(got, want, _tol(tdt))


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_ignores_nan_past_cache_len(tdt, rng):
    """Rows at or past cache_len may hold anything: NaN there leaves the
    output finite and equal to the output over the valid prefix alone (to
    1e-6: the two sum over different lengths)."""
    B, S, H, Hkv, dh, n = 2, 64, 4, 2, 80, 23
    q = torch.from_numpy(rng.normal(size=(B, H, dh)).astype(np.float32)).to(tdt)
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)).to(tdt)
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)).to(tdt)
    want = ref.flash_decode_ref(q, k[:, :n], v[:, :n], n)
    k[:, n:] = float("nan")
    v[:, n:] = float("nan")
    got = ops.flash_decode(q, k, v, torch.tensor(n, dtype=torch.int32))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------- K7's split over S

SPLIT_SHAPES = {  # (S, B, Hkv, group): the decode path, GQA, decode_32k
    "path": (4128, 4, 32, 1), "gqa": (4128, 2, 8, 8), "decode_32k": (32768, 8, 32, 1),
}


def _blocks(S, B, Hkv, group):
    head_chunks = 1 if group == 1 else -(-group // K7.GROUP_HEADS)
    return K7.plan_split(S, B, Hkv, group) * B * Hkv * head_chunks, head_chunks


@pytest.mark.parametrize("S,B,Hkv,group", [
    *SPLIT_SHAPES.values(), (4128, 2, 8, 4), (1, 4, 32, 1), (100, 1, 1, 1), (129, 1, 1, 1),
    (1037, 2, 4, 2), (2**31 - 1, 1, 1, 16),
], ids=[*SPLIT_SHAPES, "g4", "S1", "S100", "S129", "ragged", "S2^31"])
def test_plan_split_chunks_cover_the_cache(S, B, Hkv, group):
    """The kernel's chunks cover [0, S) exactly, in order, none shorter than
    MIN_CHUNK (or S), no more than MAX_SPLIT, and the grid stays within
    CUDA's limit."""
    n = K7.plan_split(S, B, Hkv, group)
    bounds = K7.chunk_bounds(S, n)
    assert bounds[0] == 0 and bounds[-1] == S and len(bounds) == n + 1
    lengths = np.diff(bounds)
    assert lengths.min() >= min(S, K7.MIN_CHUNK) and lengths.max() - lengths.min() <= 1
    assert n <= K7.MAX_SPLIT and n * _blocks(S, B, Hkv, group)[1] <= K7.MAX_GRID_Z


@pytest.mark.parametrize("shape", SPLIT_SHAPES.values(), ids=SPLIT_SHAPES.keys())
def test_plan_split_fills_the_card(shape):
    """At the path, GQA and 32k shapes the grid reaches TARGET_BLOCKS blocks
    (at least four an SM) and no chunk passes MAX_CHUNK positions."""
    S = shape[0]
    assert _blocks(*shape)[0] >= K7.TARGET_BLOCKS
    assert max(np.diff(K7.chunk_bounds(S, K7.plan_split(*shape)))) <= K7.MAX_CHUNK


def test_plan_split_one_position_is_one_chunk():
    assert K7.plan_split(1, 4, 32, 1) == 1 and K7.chunk_bounds(1, 1) == [0, 1]


def _chunk_partials(q, k, v, cache_len, bounds):
    """(m, l, acc) of each chunk [a, b) by the plain arithmetic of
    ``layers.flash_decode_shard`` on the chunk's rows (rows at or past
    cache_len masked out of the scores and the values)."""
    B, S, Hkv, dh = k.shape
    qr = q.float().reshape(B, Hkv, -1, dh)
    parts = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        valid = torch.arange(a, b) < cache_len
        kk = torch.where(valid[None, :, None, None], k[:, a:b], 0).float()
        vv = torch.where(valid[None, :, None, None], v[:, a:b], 0).float()
        scores = torch.einsum("bhgd,bshd->bhgs", qr, kk) / np.sqrt(dh)
        scores = scores.masked_fill(~valid, float("-inf"))
        local_max = scores.amax(-1)
        safe_max = torch.where(torch.isfinite(local_max), local_max, 0.0)
        probs = torch.where(valid, torch.exp(scores - safe_max[..., None]), 0.0)
        o = torch.einsum("bhgs,bshd->bhgd", probs.to(v.dtype).float(), vv)
        parts.append((local_max, probs.sum(-1), o))
    return parts


def _combine(parts, dtype):
    """The chunks' partials combined, in chunk order, by the algebra of the
    reference's sequence-sharded decode (src/repro/models/layers.py:209-219)."""
    g_max = torch.stack([m for m, _, _ in parts]).amax(0)
    l_g = o_g = 0.0
    for m, l_, o in parts:
        f = torch.where(torch.isfinite(m), torch.exp(m - g_max), 0.0)
        l_g = l_g + l_ * f
        o_g = o_g + o * f[..., None]
    out = o_g / torch.clamp_min(l_g[..., None], 1e-30)
    return out.reshape(out.shape[0], -1, out.shape[-1]).to(dtype)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("where", ["1", "first-chunk", "chunk-edge", "edge+1", "S"])
def test_chunk_partials_combine_to_the_reference(dtypes, where, rng):
    """Partials over K7's chunks, combined as the sharded decode combines its
    shards, match the plain version (NaN past cache_len) and the Pallas
    kernel in interpret mode (finite rows past cache_len: it reads them)."""
    jdt, tdt = dtypes
    B, S, H, Hkv, dh = 2, 384, 8, 2, 80
    bounds = K7.chunk_bounds(S, K7.plan_split(S, B, Hkv, H // Hkv))
    assert len(bounds) > 2
    n = {"1": 1, "first-chunk": bounds[1] // 2, "chunk-edge": bounds[1],
         "edge+1": bounds[1] + 1, "S": S}[where]
    q_j, q_t = _pair(rng.normal(size=(B, H, dh)), jdt, tdt)
    k_j, k_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    v_j, v_t = _pair(rng.normal(size=(B, S, Hkv, dh)), jdt, tdt)
    want_pallas = jax_decode(q_j, k_j, v_j, jnp.asarray(n, jnp.int32), block_k=128,
                             interpret=True)
    k_t[:, n:] = float("nan")
    v_t[:, n:] = float("nan")
    got = _combine(_chunk_partials(q_t, k_t, v_t, n, bounds), tdt)
    assert bool(torch.isfinite(got).all())
    _close(got, ref.flash_decode_ref(q_t, k_t, v_t, n).float().numpy(), _tol(tdt))
    _close(got, want_pallas, _tol(tdt))


def test_scratch_is_kept_per_device_and_stream(monkeypatch):
    """K7's workspace and tickets: made once per (device, stream), the
    tickets as zeros, and grown (the tickets as new zeros) only when a
    launch needs more."""
    monkeypatch.setattr(K7, "_scratch", {})
    dev = torch.device("cpu")
    ws, tickets = K7._scratch_for(dev, 1, 100, 10)
    assert ws.dtype == torch.float32 and ws.numel() >= 100
    assert tickets.dtype == torch.int32 and tickets.numel() >= 10 and not tickets.any()
    again = K7._scratch_for(dev, 1, 50, 4)
    assert again[0] is ws and again[1] is tickets
    other = K7._scratch_for(dev, 2, 100, 10)
    assert other[0] is not ws and other[1] is not tickets
    more_ws = K7._scratch_for(dev, 1, 1000, 10)
    assert more_ws[0].numel() >= 1000 and more_ws[1] is tickets
    more_tickets = K7._scratch_for(dev, 1, 10, 100)
    assert more_tickets[0] is more_ws[0] and more_tickets[1].numel() >= 100
    assert not more_tickets[1].any()


# ------------------------------------------------------ K6 f32: 3xTF32

TF32_MASK = np.uint32(0xFFFFE000)  # tf32 keeps 10 of f32's 23 mantissa bits


def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 as the tensor core reads a tf32 operand: the low 13 mantissa bits
    dropped."""
    return (np.asarray(x, np.float32).view(np.uint32) & TF32_MASK).view(np.float32)


def _dot_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b on f32 operands read as tf32, summed in f32."""
    return _tf32(a) @ _tf32(b)


def _split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """hopper::split_tf32: big = x's tf32 part, small = x - big (exact)."""
    big = _tf32(x)
    return big, np.asarray(x, np.float32) - big


def _dot_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as csrc/hopper.cuh's mma_3xtf32 forms it: each operand split
    into big + small, small . big + big . small + big . big with every
    operand read as tf32, each product of tf32 values exact in f32, summed
    in f32."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return _tf32(as_) @ bb + ab @ _tf32(bs) + ab @ bb


def _attend_row(q, k, v, dot):
    """One query row against every key (no mask), the kernel's arithmetic
    in f32 with both products by ``dot``: s, the softmax in f32 (p stays
    f32), p . v, out = acc / l."""
    s = dot(q[None], k.T)[0] / np.float32(np.sqrt(q.shape[0]))
    p = np.exp(s - s.max()).astype(np.float32)
    return (dot(p[None], v)[0] / p.sum(dtype=np.float32)).astype(np.float32)


def test_3xtf32_meets_the_f32_tolerance_where_one_tf32_product_does_not(rng):
    """Why the f32 kernel splits its operands: one query row against 4,096
    keys at dh 80 (the LM path's head dim), emulated in numpy with tf32 as a
    mask of the low 13 mantissa bits.  Three products stay within the
    reference's 2e-5 of an f64 computation; one product misses it."""
    S, dh = 4096, 80
    q = rng.normal(size=dh).astype(np.float32)
    k = rng.normal(size=(S, dh)).astype(np.float32)
    v = rng.normal(size=(S, dh)).astype(np.float32)
    s64 = k.astype(np.float64) @ q.astype(np.float64) / np.sqrt(dh)
    p64 = np.exp(s64 - s64.max())
    want = p64 @ v.astype(np.float64) / p64.sum()
    three = _attend_row(q, k, v, _dot_3xtf32)
    one = _attend_row(q, k, v, _dot_1xtf32)
    np.testing.assert_allclose(three, want, rtol=2e-5, atol=2e-5)
    assert not np.allclose(one, want, rtol=2e-5, atol=2e-5)
    assert np.abs(one - want).max() > 20 * np.abs(three - want).max()


def test_tf32_split_keeps_x_to_2_pow_minus_20(rng):
    """big + small is x exactly, and big + small as the tensor core reads
    them (small truncated to tf32) is within 2^-20 of x; a product of two
    tf32 values is exact in f32."""
    x = (rng.normal(size=10_000) * 1e3).astype(np.float32)
    big, small = _split(x)
    assert np.array_equal(_tf32(big), big) and np.array_equal(big + small, x)
    rel = np.abs(big.astype(np.float64) + _tf32(small) - x) / np.abs(x)
    assert rel.max() < 2.0**-20
    y = _tf32(rng.normal(size=10_000).astype(np.float32))
    assert np.array_equal((big * y).astype(np.float64), big.astype(np.float64) * y)


class _FakeLib:
    """A kernel library that records each launch's symbol and arguments."""

    def __init__(self, prefix):
        self.prefix, self.calls = prefix, []

    def __getattr__(self, sym):
        if not sym.startswith(self.prefix):
            raise AttributeError(sym)
        return lambda *args: self.calls.append((sym, args)) or 0


@pytest.fixture
def fake_k6(monkeypatch):
    """The CUDA branch of the K6 wrapper on CPU tensors, with the library,
    the device and the stream faked."""
    lib = _FakeLib(K6.NAME)
    monkeypatch.setattr(K6, "_on_cuda", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=55))
    before = (K6.launches, K6.launches_f32)
    yield lib
    K6.launches, K6.launches_f32 = before


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_f32_passes_the_callers_strides(fake_k6, causal):
    """q, k and v as views ([B, H, S, dh] storage transposed, rows of 84
    floats: 16-byte multiples, no 32-byte ones) reach the f32 kernel with
    their own strides, uncopied; the output is a new contiguous [B, S, H,
    dh]; the launch counts as an f32 one."""
    B, S, H, Hkv, dh = 2, 37, 4, 2, 80
    q = torch.zeros(B, H, S, 84)[..., :dh].transpose(1, 2)
    k = torch.zeros(B, Hkv, S, 84)[..., :dh].transpose(1, 2)
    v = torch.zeros(B, S, Hkv, dh)
    before = (K6.launches, K6.launches_f32)
    out = K6.flash_attention(q, k, v, causal)
    ((sym, a),) = fake_k6.calls
    assert sym == "flash_attention_f32"
    assert a[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert a[4:10] == (B, S, H, Hkv, dh, int(causal)) and a[11] == 55
    assert list(a[10]) == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           *out.stride()[:3]]
    assert q.stride()[:3] == (H * S * 84, 84, S * 84)
    assert out.shape == (B, S, H, dh) and out.is_contiguous() and out.dtype == torch.float32
    assert (K6.launches, K6.launches_f32) == (before[0] + 1, before[1] + 1)


def test_flash_attention_counts_bf16_launches_apart(fake_k6):
    before = (K6.launches, K6.launches_f32)
    K6.flash_attention(*_qkv())
    assert [s for s, _ in fake_k6.calls] == ["flash_attention_bf16"]
    assert (K6.launches, K6.launches_f32) == (before[0] + 1, before[1])


def test_model_prefill_f32_reaches_the_f32_kernel(fake_k6, monkeypatch):
    """The model path's f32 q, k and v (rotary and reshape of the
    projections, as models/transformer.py forms them) pass the wrapper's
    checks at every head dim the kernel takes."""
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    B, S, H, Hkv = 1, 13, 4, 2
    for dh in K6.HEAD_DIMS[torch.float32]:
        x = torch.randn(B, S, (H + 2 * Hkv) * dh)
        q, k, v = x.split((H * dh, Hkv * dh, Hkv * dh), dim=-1)
        pos = torch.arange(S)[None]
        q = L.apply_rope(q.reshape(B, S, H, dh), pos, 10_000.0)
        k = L.apply_rope(k.reshape(B, S, Hkv, dh), pos, 10_000.0)
        L.gqa_prefill_attention(q, k, v.reshape(B, S, Hkv, dh), causal=True)
    assert [a[8] for _, a in fake_k6.calls] == list(K6.HEAD_DIMS[torch.float32])
    assert {s for s, _ in fake_k6.calls} == {"flash_attention_f32"}


def test_model_prefill_bf16_reaches_the_bf16_kernel(fake_k6, monkeypatch):
    """The same in bf16 compute: every head dim the bf16 kernel takes,
    16 and 32 (lm_smoke's and lm-small's) among them."""
    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    B, S, H, Hkv = 1, 13, 4, 2
    for dh in K6.HEAD_DIMS[torch.bfloat16]:
        x = torch.randn(B, S, (H + 2 * Hkv) * dh).to(torch.bfloat16)
        q, k, v = x.split((H * dh, Hkv * dh, Hkv * dh), dim=-1)
        pos = torch.arange(S)[None]
        q = L.apply_rope(q.reshape(B, S, H, dh), pos, 10_000.0)
        k = L.apply_rope(k.reshape(B, S, Hkv, dh), pos, 10_000.0)
        L.gqa_prefill_attention(q, k, v.reshape(B, S, Hkv, dh), causal=True)
    assert [a[8] for _, a in fake_k6.calls] == list(K6.HEAD_DIMS[torch.bfloat16])
    assert [16, 32] == list(K6.HEAD_DIMS[torch.bfloat16][:2])
    assert {s for s, _ in fake_k6.calls} == {"flash_attention_bf16"}


@pytest.mark.parametrize("dh", [16, 32])
def test_flash_attention_bf16_takes_small_head_dims(fake_k6, dh):
    """bf16 at head dims 16 and 32 reaches the bf16 kernel with q as a view
    of a wider tensor (its own strides, uncopied), with and without the row
    logsumexp, and counts as two bf16 launches."""
    B, S, H, Hkv = 2, 24, 4, 2
    q = torch.zeros(B, H, S, 2 * dh, dtype=torch.bfloat16)[..., :dh].transpose(1, 2)
    k, v = (torch.zeros(B, S, Hkv, dh, dtype=torch.bfloat16) for _ in "kv")
    lse = torch.empty(B, H, S)
    before = (K6.launches, K6.launches_f32)
    out = K6.flash_attention(q, k, v, True, lse=lse)
    out2 = K6.flash_attention(q, k, v, False)
    (sym, a), (sym2, b) = fake_k6.calls
    assert sym == sym2 == "flash_attention_bf16"
    assert a[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert b[3] == out2.data_ptr()
    assert a[4:10] == (B, S, H, Hkv, dh, 1) and b[4:10] == (B, S, H, Hkv, dh, 0)
    assert list(a[10]) == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           *out.stride()[:3]]
    assert q.stride()[:3] == (H * S * 2 * dh, 2 * dh, S * 2 * dh)
    assert a[11] == b[11] == 55 and a[12] == lse.data_ptr() and b[12] is None
    for o in (out, out2):
        assert o.shape == (B, S, H, dh) and o.is_contiguous() and o.dtype == torch.bfloat16
    assert (K6.launches, K6.launches_f32) == (before[0] + 2, before[1])


@pytest.fixture
def fake_k7(monkeypatch):
    """The CUDA branch of the K7 wrappers on CPU tensors, with the library,
    the device and the stream faked."""
    lib = _FakeLib(K7.NAME)
    monkeypatch.setattr(K7, "_on_cuda", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=55))
    monkeypatch.setattr(K7, "_scratch", {})
    before = (K7.launches, K7.launches_partial)
    yield lib
    K7.launches, K7.launches_partial = before


@pytest.mark.parametrize("dh", [16, 32])
def test_flash_decode_bf16_takes_small_head_dims(fake_k7, dh):
    """K7 in bf16 at head dims 16 and 32, in both modes: the bf16 symbol,
    pointers, shapes, the split and the stream; the serving launch returns
    bf16 and passes no shard start, the shard mode an f32 sum and (m, l)."""
    B, S, H, Hkv = 2, 300, 8, 2
    q = torch.zeros(B, H, dh, dtype=torch.bfloat16)
    kc = torch.zeros(B, S, Hkv, dh, dtype=torch.bfloat16)
    vc = torch.zeros(B, S, Hkv, dh, dtype=torch.bfloat16)
    n, start = torch.tensor(200, dtype=torch.int32), torch.tensor(64, dtype=torch.int32)
    before = (K7.launches, K7.launches_partial)
    out = K7.flash_decode(q, kc, vc, n)
    o, m, l_sum = K7.flash_decode_partial(q, kc, vc, n, start)
    (sym, a), (sym2, b) = fake_k7.calls
    assert sym == sym2 == "flash_decode_bf16"
    for args in (a, b):
        assert args[:4] == (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), n.data_ptr())
        assert args[9:] == (B, S, H, Hkv, dh, K7.plan_split(S, B, Hkv, H // Hkv), 55)
    assert a[4] is None and a[6] is None and a[5] == out.data_ptr()
    assert b[4] == start.data_ptr() and b[5] == o.data_ptr() and b[6] == m.data_ptr()
    assert out.dtype == torch.bfloat16 and out.shape == (B, H, dh)
    assert o.dtype == m.dtype == l_sum.dtype == torch.float32 and o.shape == (B, H, dh)
    assert (K7.launches, K7.launches_partial) == (before[0] + 2, before[1] + 1)


# ------------------------------------------------------- wrapper refusals


def _qkv(B=1, S=8, H=2, Hkv=1, dh=80, dtype=torch.bfloat16):
    return (torch.zeros(B, S, H, dh, dtype=dtype), torch.zeros(B, S, Hkv, dh, dtype=dtype),
            torch.zeros(B, S, Hkv, dh, dtype=dtype))


def _decode_args(B=1, S=8, H=2, Hkv=1, dh=80, dtype=torch.bfloat16):
    return (torch.zeros(B, H, dh, dtype=dtype), torch.zeros(B, S, Hkv, dh, dtype=dtype),
            torch.zeros(B, S, Hkv, dh, dtype=dtype), torch.tensor(3, dtype=torch.int32))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises; it never computes on the CPU."""
    before = (K6.launches, K7.launches)
    with pytest.raises(ValueError, match="CUDA"):
        K6.flash_attention(*_qkv())
    with pytest.raises(ValueError, match="CUDA"):
        K7.flash_decode(*_decode_args())
    assert (K6.launches, K7.launches) == before


@pytest.mark.parametrize("dh", [16, 32])
def test_bf16_small_head_dims_pass_the_checks(dh):
    """bf16 at head dims 16 and 32 passes both wrappers' checks; CPU
    tensors are then refused as at any other head dim, nothing launched."""
    before = (K6.launches, K7.launches)
    K6.check_inputs(*_qkv(dh=dh))
    K7.check_inputs(*_decode_args(dh=dh))
    with pytest.raises(ValueError, match="CUDA"):
        K6.flash_attention(*_qkv(dh=dh))
    with pytest.raises(ValueError, match="CUDA"):
        K7.flash_decode(*_decode_args(dh=dh))
    assert (K6.launches, K7.launches) == before


@pytest.mark.parametrize(
    "args,exc,match",
    [
        (_qkv(dtype=torch.float16), TypeError, "dtype"),
        (_qkv(dh=48), ValueError, "head dim 48"),
        (_qkv(dh=16), ValueError, "CUDA"),  # taken: refused only for lying on the CPU
        (_qkv(dh=8), ValueError, "head dim 8"),
        (_qkv(H=3, Hkv=2), ValueError, "Hkv divides H"),
        ((torch.zeros(8, 2, 80), torch.zeros(1, 8, 1, 80), torch.zeros(1, 8, 1, 80)),
         ValueError, "want q"),
        ((torch.zeros(1, 8, 2, 80), torch.zeros(1, 8, 1, 80), torch.zeros(1, 8, 1, 80,
                                                                          dtype=torch.bfloat16)),
         TypeError, "dtype"),
        ((torch.zeros(1, 8, 2, 160)[..., ::2],) + _qkv(dtype=torch.float32)[1:],
         ValueError, "strides"),
        ((torch.zeros(1, 8, 2, 84, dtype=torch.bfloat16)[..., :80],) + _qkv()[1:],
         ValueError, "strides"),
        ((torch.zeros(8 * 2 * 80 + 8, dtype=torch.bfloat16)[1:8 * 2 * 80 + 1].view(1, 8, 2, 80),)
         + _qkv()[1:], ValueError, "16-byte boundary"),
        ((torch.zeros(1, 1, 1, 80, dtype=torch.bfloat16).expand(1, 2**31, 1, 80),) * 3,
         ValueError, "positions"),
    ],
    ids=["f16", "dh48", "dh16", "dh8", "groups", "rank", "mixed", "strided", "row-pitch",
         "misaligned", "too-long"],
)
def test_flash_attention_refuses_bad_input(args, exc, match):
    with pytest.raises(exc, match=match):
        K6.flash_attention(*args)


@pytest.mark.parametrize(
    "args,exc,match",
    [
        (_decode_args(dtype=torch.float16), TypeError, "dtype"),
        (_decode_args(dh=40), ValueError, "head dim 40"),
        (_decode_args(dh=48, dtype=torch.float32), ValueError, "head dim 48"),
        (_decode_args(dh=8), ValueError, "head dim 8"),
        (_decode_args(H=3, Hkv=2), ValueError, "Hkv divides H"),
        (_decode_args()[:3] + (torch.tensor(3),), TypeError, "int32"),
        (_decode_args()[:3] + (torch.tensor([3, 4], dtype=torch.int32),), TypeError, "int32"),
        ((torch.zeros(1, 8, 2, 80),) + _decode_args(dtype=torch.float32)[1:],
         ValueError, "want q"),
        ((torch.zeros(1, 2, 160)[..., ::2],) + _decode_args(dtype=torch.float32)[1:],
         ValueError, "contiguous"),
    ],
    ids=["f16", "dh40", "f32-dh48", "dh8", "groups", "int64-len", "two-lens", "rank",
         "strided"],
)
def test_flash_decode_refuses_bad_input(args, exc, match):
    with pytest.raises(exc, match=match):
        K7.flash_decode(*args)


def test_ops_reject_other_devices():
    """A device other than cuda, cpu and meta (the dry run's, which takes
    the card's route) raises, and so do tensors on two kinds of device."""
    other = [types.SimpleNamespace(device=torch.device("xpu"), requires_grad=False)] * 4
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(*other[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_decode(*other)
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="one device type"):
        ops.flash_attention(q.to("meta"), k, v)
    args = _decode_args()
    with pytest.raises(ValueError, match="one device type"):
        ops.flash_decode(*[t.to("meta") for t in args[:3]], args[3])


def test_flash_decode_shard_refuses_the_sharded_combine():
    """A combine over mesh axes needs the mesh; a shard offset alone is one
    shard's own softmax: positions shard_start .. of the whole cache."""
    with pytest.raises(ValueError, match="need the mesh"):
        L.flash_decode_shard(*_decode_args(dtype=torch.float32), combine_axes=("model",))
    q, k, v, _ = _decode_args(S=16, dtype=torch.float32)
    for t in (q, k, v):
        t.normal_(generator=torch.Generator().manual_seed(0))
    n = torch.tensor(13, dtype=torch.int32)
    got = L.flash_decode_shard(q, k[:, 8:], v[:, 8:], n, shard_start=8)
    torch.testing.assert_close(got, ref.flash_decode_ref(q, k[:, 8:], v[:, 8:], 5),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mod", [K6, K7], ids=["flash_attention", "flash_decode"])
def test_bound_symbols_exist_in_source(mod):
    """Every C function a wrapper binds is exported by its .cu source, the
    source instantiates every head dim the wrapper accepts, and the library
    name carries a hash of that source."""
    src = (build.CSRC / f"{mod.NAME}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(mod._SYMBOLS.values()) | {f"{mod.NAME}_error_string"} <= exported
    cases = {int(d) for d in re.findall(r"case (\d+):", src)}
    assert set().union(*mod.HEAD_DIMS.values()) == cases
    path = build.library_path(mod.NAME)
    assert re.fullmatch(rf"lib{mod.NAME}-[0-9a-f]{{16}}\.so", path.name)
