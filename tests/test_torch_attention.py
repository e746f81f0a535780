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
import re

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


@pytest.mark.parametrize(
    "args,exc,match",
    [
        (_qkv(dtype=torch.float16), TypeError, "dtype"),
        (_qkv(dh=48), ValueError, "head dim 48"),
        (_qkv(dh=16), ValueError, "head dim 16"),
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
    ids=["f16", "dh48", "dh16", "groups", "rank", "mixed", "strided", "row-pitch",
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
        (_decode_args(H=3, Hkv=2), ValueError, "Hkv divides H"),
        (_decode_args()[:3] + (torch.tensor(3),), TypeError, "int32"),
        (_decode_args()[:3] + (torch.tensor([3, 4], dtype=torch.int32),), TypeError, "int32"),
        ((torch.zeros(1, 8, 2, 80),) + _decode_args(dtype=torch.float32)[1:],
         ValueError, "want q"),
        ((torch.zeros(1, 2, 160)[..., ::2],) + _decode_args(dtype=torch.float32)[1:],
         ValueError, "contiguous"),
    ],
    ids=["f16", "dh40", "groups", "int64-len", "two-lens", "rank", "strided"],
)
def test_flash_decode_refuses_bad_input(args, exc, match):
    with pytest.raises(exc, match=match):
        K7.flash_decode(*args)


def test_ops_reject_other_devices():
    meta = [t.to("meta") for t in _qkv()]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_decode(*[t.to("meta") for t in _decode_args()])


def test_flash_decode_shard_refuses_the_sharded_combine():
    with pytest.raises(NotImplementedError, match="single-device"):
        L.flash_decode_shard(*_decode_args(dtype=torch.float32), combine_axes=("model",))
    with pytest.raises(NotImplementedError, match="single-device"):
        L.flash_decode_shard(*_decode_args(dtype=torch.float32), shard_start=8)


@pytest.mark.parametrize("mod", [K6, K7], ids=["flash_attention", "flash_decode"])
def test_bound_symbols_exist_in_source(mod):
    """Every C function a wrapper binds is exported by its .cu source, the
    source instantiates every head dim the wrapper accepts, and the library
    name carries a hash of that source."""
    src = (build.CSRC / f"{mod.NAME}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(mod._SYMBOLS.values()) | {f"{mod.NAME}_error_string"} <= exported
    cases = {int(d) for d in re.findall(r"case (\d+):", src)}
    assert set(mod.HEAD_DIMS) == cases
    path = build.library_path(mod.NAME)
    assert re.fullmatch(rf"lib{mod.NAME}-[0-9a-f]{{16}}\.so", path.name)
