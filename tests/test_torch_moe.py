"""repro_torch's MoE layer, its LM configs and K7's shard mode against the
JAX package on the CPU.

The same numpy-seeded inputs go through ``repro.models.moe`` and
``repro_torch.models.moe``; the reference's transformer weights are carried
across with ``params_from_numpy``, experts included.  Routing is compared
bit for bit: ``top_e`` against the one the reference's ``jax.lax.top_k``
returned (recorded by wrapping it), the dispatch slots against the
reference's own arithmetic on that ``top_e`` (``_jax_slots``, its lines
moe.py:85-100).  Tolerances: 1e-5 for the layer's f32 output and aux;
1e-4 for f32 logits and caches after a few layers (sums in other orders);
the bf16 forward at ``tests/test_torch_transformer.py``'s bf16 tolerance.
On the CPU attention takes K6's and K7's plain versions; ``chip_smoke.py``
runs the same paths through the kernels on the card.
"""
import contextlib
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.arctic_480b import CONFIG as JAX_ARCTIC
from repro.configs.llama3_405b import CONFIG as JAX_LLAMA3
from repro.configs.olmoe_1b_7b import CONFIG as JAX_OLMOE
from repro.configs.qwen2_72b import CONFIG as JAX_QWEN2
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import arctic_480b, llama3_405b, olmoe_1b_7b, qwen2_72b
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_decode as K7
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T

TOL = 1e-5
D, E, K, F = 32, 8, 2, 48


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


# ----------------------------------------------------------------- routing


@pytest.mark.parametrize("tokens,top_k,cf,experts", [
    (1, 1, 1.25, 8), (4, 8, 1.25, 64), (16384, 8, 1.25, 64), (4096, 2, 1.25, 128),
    (22, 2, 1.25, 8), (100, 2, 0.5, 8), (2056, 8, 8.0, 64), (33, 3, 1.0, 7),
])
def test_moe_capacity_matches_jax(tokens, top_k, cf, experts):
    jcfg = JM.MoEConfig(num_experts=experts, top_k=top_k, d_ff=8, capacity_factor=cf)
    tcfg = TM.MoEConfig(num_experts=experts, top_k=top_k, d_ff=8, capacity_factor=cf)
    assert TM.moe_capacity(tcfg, tokens) == JM.moe_capacity(jcfg, tokens)
    assert TM.moe_capacity(tcfg, tokens) % 8 == 0 and TM.moe_capacity(tcfg, tokens) >= 8


def _moe_inputs(rng, T_=40, ties=False):
    """Params with the reference's scales (numpy-seeded) and tokens [T, D].
    With ``ties`` the router's columns 3, 5 and 6 repeat column 1 and column
    7 repeats column 0, so those experts' logits tie exactly on every
    token."""
    p = {"router": rng.uniform(-1, 1, (D, E)) / np.sqrt(D),
         "w_gate": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "w_up": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "w_down": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    if ties:
        p["router"][:, [3, 5, 6]] = p["router"][:, [1]]
        p["router"][:, 7] = p["router"][:, 0]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.normal(size=(T_, D)).astype(np.float32)


def _jax_slots(top_e, cfg, T_: int, n_shards: int, shard):
    """The reference's dispatch slots on its own top_e (moe.py:85-100)."""
    E_loc, C = cfg.num_experts // n_shards, JM.moe_capacity(cfg, T_)
    base = jnp.zeros((cfg.num_experts,), jnp.int32)
    slots = []
    for kk in range(cfg.top_k):
        onehot = jax.nn.one_hot(top_e[:, kk], cfg.num_experts, dtype=jnp.int32)
        ranks = jnp.cumsum(onehot, axis=0) - onehot + base[None, :]
        rank = (ranks * onehot).sum(-1)
        base = base + onehot.sum(0)
        keep = rank < C
        e_k = top_e[:, kk]
        if shard is None:
            local_mask, local_e = keep, e_k
        else:
            local_mask = keep & (e_k // E_loc == shard)
            local_e = e_k - shard * E_loc
        slots.append(jnp.where(local_mask, local_e * C + rank, E_loc * C))
    return np.stack([np.asarray(s) for s in slots])


@contextlib.contextmanager
def _recording_top_k(monkeypatch):
    """``jax.lax.top_k`` wrapped to keep what it returns."""
    seen = []
    real = jax.lax.top_k

    def top_k(x, k):
        out = real(x, k)
        seen.append(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    yield seen
    monkeypatch.setattr(jax.lax, "top_k", real)


def _local(p: dict, n: int, s: int) -> dict:
    """Shard ``s`` of ``n`` of the expert weights (the router whole)."""
    el = E // n
    return {k: v if k == "router" else v[s * el:(s + 1) * el] for k, v in p.items()}


ROUTING_CASES = {  # (capacity factor, planted ties, tokens)
    "plain": (1.25, False, 40), "ties": (1.25, True, 40), "drops": (0.5, False, 40),
    "ties_and_drops": (0.5, True, 64), "one_token": (1.25, False, 1),
}


@pytest.mark.parametrize("case", list(ROUTING_CASES))
@pytest.mark.parametrize("shards", [1, 4], ids=["whole", "4shards"])
def test_moe_apply_local_matches_jax(case, shards, rng, monkeypatch):
    """top_e and slots bit-equal to the reference's, the partial output and
    aux within 1e-5, for every expert shard; with planted ties (duplicate
    router columns: the reference's top_k breaks them to the lowest expert,
    and so must the port) and a capacity factor that drops assignments."""
    cf, ties, T_ = ROUTING_CASES[case]
    p, x = _moe_inputs(rng, T_, ties)
    jcfg = JM.MoEConfig(num_experts=E, top_k=K, d_ff=F, capacity_factor=cf)
    tcfg = TM.MoEConfig(num_experts=E, top_k=K, d_ff=F, capacity_factor=cf)
    C = TM.moe_capacity(tcfg, T_)
    for s in range(shards):
        shard = None if shards == 1 else s
        jp = {k: jnp.asarray(v) for k, v in _local(p, shards, s).items()}
        with _recording_top_k(monkeypatch) as seen:
            want, want_aux = JM.moe_apply_local(
                jp, jnp.asarray(x), jcfg, shards, None if shard is None else jnp.int32(s))
        (_, j_top_e), = seen
        tp = {k: torch.from_numpy(v) for k, v in _local(p, shards, s).items()}
        _, t_top_e, t_slots, t_aux = TM.moe_route(tp["router"], torch.from_numpy(x), tcfg,
                                                  shards, shard)
        np.testing.assert_array_equal(t_top_e.numpy(), np.asarray(j_top_e))
        np.testing.assert_array_equal(
            t_slots.numpy(), _jax_slots(j_top_e, jcfg, T_, shards,
                                        None if shard is None else jnp.int32(s)))
        got, aux = TM.moe_apply_local(tp, torch.from_numpy(x), tcfg, shards, shard)
        assert got.shape == (T_, D) and got.dtype == torch.float32
        _close(got, want, TOL)
        _close(aux, want_aux, TOL)
    if ties:  # the plant took: tied experts inside some token's top k
        probs = torch.softmax(torch.from_numpy(x @ p["router"]), -1)
        top2 = probs.topk(K + 1).values
        assert bool((top2[:, :-1] == top2[:, 1:]).any())
    if cf < 1 and shards == 1:  # the capacity bites: some assignments dropped
        assert bool((t_slots == E * C).any())


def test_moe_shards_sum_to_the_whole(rng):
    """The partials of every expert shard sum to the unsharded output (the
    all-reduce over `model` of the transformer's expert layer), drops
    included."""
    p, x = _moe_inputs(rng, 64, ties=True)
    cfg = TM.MoEConfig(num_experts=E, top_k=K, d_ff=F, capacity_factor=0.75)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    whole, aux = TM.moe_apply_reference(tp, torch.from_numpy(x), cfg)
    parts = [TM.moe_apply_local(_local(tp, 4, s), torch.from_numpy(x), cfg, 4, s)
             for s in range(4)]
    torch.testing.assert_close(sum(o for o, _ in parts), whole, rtol=1e-6, atol=1e-6)
    assert all(torch.equal(a, aux) for _, a in parts)


def test_moe_refuses_whole_weights_for_a_shard(rng):
    p, x = _moe_inputs(rng, 8)
    cfg = TM.MoEConfig(num_experts=E, top_k=K, d_ff=F)
    with pytest.raises(ValueError, match="local shard"):
        TM.moe_apply_local({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), cfg, 4, 1)


def test_moe_init_follows_the_reference_tree():
    """Keys, shapes, dtypes and scales of the reference's moe_init."""
    cfg = TM.MoEConfig(num_experts=E, top_k=K, d_ff=64)
    got = TM.moe_init(torch.Generator().manual_seed(0), cfg, 128, device="cpu")
    want = jax.eval_shape(lambda k: JM.moe_init(k, JM.MoEConfig(E, K, 64), 128),
                          jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert float(got["router"].abs().max()) <= 1 / math.sqrt(128)
    assert 0.9 < float(got["w_gate"].std()) * math.sqrt(128) < 1.1
    assert 0.9 < float(got["w_down"].std()) * math.sqrt(64) < 1.1


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
def test_layer_norm_matches_jax(bias, dtypes, rng):
    jdt, tdt = dtypes
    x = (rng.normal(size=(3, 5, 80)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(80,)).astype(np.float32)
    b = rng.normal(size=(80,)).astype(np.float32) if bias else None
    want = JL.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                         None if b is None else jnp.asarray(b, jdt), 1e-5)
    got = L.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                       None if b is None else torch.from_numpy(b).to(tdt), 1e-5)
    assert got.dtype == tdt
    _close(got, want, 1e-5 if tdt == torch.float32 else 1e-2)


def test_kv_cache_update_shard_writes_the_owner_only(rng):
    """Four shards of a 16-position cache: the write lands in the shard
    that owns ``pos`` and leaves the others as they were, as the
    reference's owner-shard update does."""
    cache = rng.normal(size=(2, 16, 3, 8)).astype(np.float32)
    new = rng.normal(size=(2, 3, 8)).astype(np.float32)
    for pos in (0, 5, 11, 15, 16, -1):
        for s in range(4):
            shard = torch.from_numpy(cache[:, 4 * s:4 * (s + 1)].copy())
            want = JL.kv_cache_update_shard(
                jnp.asarray(cache[:, 4 * s:4 * (s + 1)]), jnp.asarray(new),
                jnp.asarray(pos, jnp.int32), jnp.asarray(4 * s, jnp.int32))
            out = L.kv_cache_update_shard(shard, torch.from_numpy(new),
                                          torch.tensor(pos, dtype=torch.int32),
                                          torch.tensor(4 * s, dtype=torch.int32))
            assert out is shard
            np.testing.assert_array_equal(shard.numpy(), np.asarray(want))


# -------------------------------------------------------- K7's shard mode


def _decode_inputs(rng, tdt, B=2, S=40, H=8, Hkv=2, dh=80):
    q = torch.from_numpy(rng.normal(size=(B, H, dh)).astype(np.float32)).to(tdt)
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)).to(tdt)
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)).to(tdt)
    return q, k, v


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("start", [0, 10, 25, 30, 40], ids=["first", "inside", "edge-1",
                                                           "edge", "past"])
def test_flash_decode_partial_matches_jax_shard(tdt, start, rng):
    """The shard mode's plain version on a shard of 10 positions starting at
    ``start`` of a 50-position cache, cache_len 30 (the shard before, across
    and past cache_len, and empty), NaN past cache_len: its output divided
    by its sum is the reference's ``flash_decode_shard`` on that shard alone
    (combine_axes=(), where the reference's psum algebra leaves the shard's
    own softmax); m and l are the shard's max and sum, computed in numpy; an
    empty shard gives m = -inf, l = 0, o = 0.  The reference reads the rows
    past cache_len (0 times a NaN row is NaN), so its copy holds zeros
    there."""
    n, S_loc = 30, 10
    q, k, v = _decode_inputs(rng, tdt, S=50)
    k[:, n:] = float("nan")
    v[:, n:] = float("nan")
    kl, vl = k[:, start:start + S_loc], v[:, start:start + S_loc]
    o, m, l_sum = ops.flash_decode_partial(q, kl, vl, torch.tensor(n, dtype=torch.int32),
                                           torch.tensor(start, dtype=torch.int32))
    assert o.dtype == m.dtype == l_sum.dtype == torch.float32
    assert o.shape == q.shape and m.shape == l_sum.shape == q.shape[:2]
    assert bool(torch.isfinite(o).all()) and not bool(torch.isnan(m).any())
    live = max(0, min(n - start, S_loc))
    if live == 0:
        assert bool((m == float("-inf")).all()) and not l_sum.any() and not o.any()
        return
    qf, kf = q.float().numpy(), kl[:, :live].float().numpy()
    s = np.einsum("bhgd,bshd->bhgs", qf.reshape(2, 2, 4, 80), kf) / np.sqrt(80)
    np.testing.assert_allclose(m.numpy(), s.max(-1).reshape(2, 8), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l_sum.numpy(), np.exp(s - s.max(-1, keepdims=True)).sum(-1)
                               .reshape(2, 8), rtol=1e-5, atol=1e-6)
    jdt = jnp.float32 if tdt == torch.float32 else jnp.bfloat16
    # the reference multiplies the masked rows by 0: give it finite ones
    j = {name: jnp.asarray(np.nan_to_num(_np(t)), jdt)
         for name, t in (("q", q), ("k", kl), ("v", vl))}
    want = JL.flash_decode_shard(j["q"], j["k"], j["v"], jnp.asarray(n, jnp.int32),
                                 jnp.asarray(start, jnp.int32), combine_axes=())
    got = (o / torch.clamp_min(l_sum[..., None], 1e-30)).to(tdt)
    _close(got, want, 2e-5 if tdt == torch.float32 else 3e-2)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 17, 33, 40])
def test_shard_partials_combine_to_the_whole_cache(tdt, n, rng):
    """Four shards' partials, combined by the reference's algebra
    (layers.py:209-219, the max, then sums scaled by exp(m - max)),
    give the reference's decode over the whole cache, shards past cache_len
    empty."""
    q, k, v = _decode_inputs(rng, tdt)
    parts = [ops.flash_decode_partial(q, k[:, 10 * s:10 * (s + 1)], v[:, 10 * s:10 * (s + 1)],
                                      torch.tensor(n, dtype=torch.int32),
                                      torch.tensor(10 * s, dtype=torch.int32))
             for s in range(4)]
    g_max = torch.stack([m for _, m, _ in parts]).amax(0)
    o_g = l_g = 0
    for o, m, l_sum in parts:
        f = torch.where(torch.isfinite(m), torch.exp(m - g_max), 0.0)
        o_g, l_g = o_g + o * f[..., None], l_g + l_sum * f
    got = (o_g / torch.clamp_min(l_g[..., None], 1e-30)).to(tdt)
    jdt = jnp.float32 if tdt == torch.float32 else jnp.bfloat16
    want = JL.flash_decode_shard(*(jnp.asarray(_np(t), jdt) for t in (q, k, v)),
                                 jnp.asarray(n, jnp.int32), jnp.zeros((), jnp.int32),
                                 combine_axes=())
    _close(got, want, 2e-5 if tdt == torch.float32 else 3e-2)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, sym):
        if not sym.startswith(K7.NAME):
            raise AttributeError(sym)
        return lambda *args: self.calls.append((sym, args)) or 0


def test_flash_decode_partial_launches_the_shard_mode(monkeypatch):
    """The wrapper's CUDA branch with the library faked: the shard mode
    passes the shard start and a [B, H, 2] f32 (m, l) buffer, returns an f32
    output, and counts as a launch and a shard-mode launch; the plain call
    passes null for both."""
    lib = _FakeLib()
    monkeypatch.setattr(K7, "_on_cuda", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(build, "check", lambda lib_, name, code: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(K7, "_scratch", {})
    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    kc = torch.zeros(2, 300, 2, 128, dtype=torch.bfloat16)
    n, start = torch.tensor(200, dtype=torch.int32), torch.tensor(100, dtype=torch.int32)
    before = (K7.launches, K7.launches_partial)
    o, m, l_sum = K7.flash_decode_partial(q, kc, kc, n, start)
    out = K7.flash_decode(q, kc, kc, n)
    (sym, a), (sym2, a2) = lib.calls
    assert sym == sym2 == "flash_decode_bf16"
    assert a[:4] == (q.data_ptr(), kc.data_ptr(), kc.data_ptr(), n.data_ptr())
    assert a[4] == start.data_ptr() and a[5] == o.data_ptr() and a[6] == m.data_ptr()
    assert a[9:] == (2, 300, 8, 2, 128, K7.plan_split(300, 2, 2, 4), 77)
    assert o.dtype == m.dtype == l_sum.dtype == torch.float32 and o.shape == (2, 8, 128)
    assert l_sum.data_ptr() == m.data_ptr() + 4 and m.stride() == (16, 2)
    assert a2[4] is None and a2[6] is None and a2[5] == out.data_ptr()
    assert out.dtype == torch.bfloat16
    assert (K7.launches, K7.launches_partial) == (before[0] + 2, before[1] + 1)
    K7.launches, K7.launches_partial = before


def test_flash_decode_partial_refuses_a_bad_start():
    q, k, v = _decode_inputs(np.random.default_rng(0), torch.bfloat16)
    with pytest.raises(TypeError, match="shard_start must be an int32"):
        K7.flash_decode_partial(q, k, v, torch.tensor(3, dtype=torch.int32), torch.tensor(3))
    with pytest.raises(ValueError, match="CUDA"):
        K7.flash_decode_partial(q, k, v, torch.tensor(3, dtype=torch.int32),
                                torch.tensor(3, dtype=torch.int32))


# ------------------------------------------------------------------ model


TINY = dict(name="tiny-moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=128, d_head=8)


def _configs(compute=jnp.float32, dense_residual=False, cf=1.25):
    jdt_to_t = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    jcfg = JT.TransformerConfig(**TINY, compute_dtype=compute, remat_groups=2,
                                moe=JM.MoEConfig(num_experts=E, top_k=K, d_ff=F,
                                                 capacity_factor=cf),
                                moe_dense_residual=dense_residual)
    tcfg = T.TransformerConfig(**TINY, compute_dtype=jdt_to_t[compute],
                               moe=TM.MoEConfig(num_experts=E, top_k=K, d_ff=F,
                                                capacity_factor=cf),
                               moe_dense_residual=dense_residual)
    return jcfg, tcfg


def _carry(jcfg, tcfg, seed=0):
    jparams = JT.init_params(jcfg, jax.random.key(seed))
    return jparams, T.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                                        "cpu")


@pytest.mark.parametrize("dense_residual", [False, True], ids=["moe", "moe+dense"])
def test_moe_forward_and_prefill_match_jax(dense_residual, rng):
    """22 tokens, capacity 8 a expert: some assignments drop.  Logits, aux
    and the prefill's caches against the reference's."""
    jcfg, tcfg = _configs(dense_residual=dense_residual)
    jparams, tparams = _carry(jcfg, tcfg)
    assert set(tparams["layers"]) == set(jparams["layers"])
    assert ("wg" in tparams["layers"]) == dense_residual
    toks = rng.integers(0, jcfg.vocab, (2, 11)).astype(np.int32)
    jl, jaux = JT.forward(jcfg, jparams, jnp.asarray(toks), None)
    tl, aux = T.forward(tcfg, tparams, torch.from_numpy(toks))
    assert tl.shape == (2, 11, tcfg.padded_vocab()) and float(aux) > 0
    _close(tl, jl, 1e-4)
    _close(aux, jaux, TOL)
    jlast, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks), None)
    tlast, (tk, tv) = T.prefill(tcfg, tparams, torch.from_numpy(toks))
    _close(tlast, jlast, 1e-4)
    _close(tk, jk, 1e-4)
    _close(tv, jv, 1e-4)


@pytest.mark.parametrize("dense_residual", [False, True], ids=["moe", "moe+dense"])
def test_moe_decode_steps_match_jax(dense_residual, rng):
    """Prefill 8 tokens, pad the caches to 16, then 4 decode steps: logits
    and the updated caches against the reference's."""
    jcfg, tcfg = _configs(dense_residual=dense_residual)
    jparams, tparams = _carry(jcfg, tcfg, seed=1)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    _, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :8]), None)
    pad = ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))
    jk, jv = jnp.pad(jk, pad), jnp.pad(jv, pad)
    _, (tk, tv) = T.prefill(tcfg, tparams, torch.from_numpy(toks[:, :8]))
    k_cache, v_cache = T.init_decode_cache(tcfg, 2, 16, device="cpu")
    k_cache[:, :, :8], v_cache[:, :, :8] = tk, tv
    cache = (k_cache, v_cache)
    for step in range(8, 12):
        jlog, (jk, jv) = JT.decode_step(jcfg, jparams, (jk, jv), jnp.asarray(toks[:, step]),
                                        jnp.asarray(step, jnp.int32), None)
        tlog, cache = T.decode_step(tcfg, tparams, cache, torch.from_numpy(toks[:, step]),
                                    torch.tensor(step, dtype=torch.int32))
        assert cache[0] is k_cache
        _close(tlog, jlog, 1e-4)
        _close(cache[0], jk, 1e-4)
        _close(cache[1], jv, 1e-4)


def test_moe_decode_matches_forward(rng):
    """Inside the port: prefill 8 and 4 decode steps against one forward
    over the 12 tokens, with a capacity that drops nothing (the forward
    routes 24 tokens at once, each step 2)."""
    _, cfg = _configs(dense_residual=True, cf=E / K)
    params = T.init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))
    _, (kc, vc) = T.prefill(cfg, params, toks[:, :8])
    k_cache, v_cache = T.init_decode_cache(cfg, 2, 16, device="cpu")
    k_cache[:, :, :8], v_cache[:, :, :8] = kc, vc
    full, _ = T.forward(cfg, params, toks)
    for step in range(8, 12):
        logits, _ = T.decode_step(cfg, params, (k_cache, v_cache), toks[:, step],
                                  torch.tensor(step, dtype=torch.int32))
        torch.testing.assert_close(logits, full[:, step], rtol=1e-4, atol=1e-4)


def test_moe_bf16_compute_matches_jax(rng):
    """bf16 activations (f32 weights), at test_torch_transformer.py's bf16
    tolerance (rtol 3e-2, atol four bf16 ulps in [2, 4)).  Routing runs on
    logits rounded to bf16 in both, so it is compared first: every token's
    top-k set in both layers must agree for the comparison to hold."""
    jcfg, tcfg = _configs(compute=jnp.bfloat16, dense_residual=True)
    jparams, tparams = _carry(jcfg, tcfg, seed=2)
    toks = rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    jlast, (jk, _) = JT.prefill(jcfg, jparams, jnp.asarray(toks), None)
    tlast, (tk, _) = T.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert tlast.dtype == torch.bfloat16 and tk.dtype == torch.bfloat16
    for got, want in ((tlast, jlast), (tk, jk)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=3e-2, atol=6.25e-2)


# ------------------------------------------------------------ configuration


CONFIGS = {"olmoe-1b-7b": (olmoe_1b_7b, JAX_OLMOE, 6_919_096_320),
           "arctic-480b": (arctic_480b, JAX_ARCTIC, None),
           "qwen2-72b": (qwen2_72b, JAX_QWEN2, None),
           "llama3-405b": (llama3_405b, JAX_LLAMA3, None)}
FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head",
          "qkv_bias", "rope_theta", "norm_eps", "moe_dense_residual")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_config_matches_jax(name):
    """The serving fields, the experts' config, num_params and the mesh
    geometry (heads, vocab and KV sharding at tp 1 and on the 16x16 pod)
    equal the reference's CONFIG."""
    mod, want, n_params = CONFIGS[name]
    cfg = mod.make_config()
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(want, f), f
    assert (cfg.moe is None) == (want.moe is None)
    if cfg.moe is not None:
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(want.moe)
    pod = AbstractMesh((16, 16), ("data", "model"))
    for mesh in (None, pod):
        assert cfg.tp(mesh) == want.tp(mesh)
        assert cfg.num_params(mesh) == want.num_params(mesh)
        assert cfg.padded_heads(mesh) == want.padded_heads(mesh)
        assert cfg.padded_vocab(mesh) == want.padded_vocab(mesh)
        assert cfg.kv_sharded(mesh) == want.kv_sharded(mesh)
    assert n_params is None or cfg.num_params() == n_params
    assert (cfg.param_dtype, cfg.compute_dtype) == (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dense_residual", [False, True], ids=["moe", "moe+dense"])
def test_moe_init_params_tree_matches_jax(dense_residual):
    """Keys, shapes and dtypes of the reference's tree, with a mesh's
    padding (6 heads -> 8, vocab 128 -> 512 at tp 4); num_params counts
    them; the experts' scales follow the reference."""
    _, tcfg = _configs(dense_residual=dense_residual)
    tcfg = dataclasses.replace(tcfg, n_heads=6)
    jcfg = JT.TransformerConfig(**dict(TINY, n_heads=6), moe=JM.MoEConfig(E, K, F),
                                moe_dense_residual=dense_residual)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    jtree = JT.abstract_params(jcfg, mesh)
    params = T.init_params(tcfg, seed=0, device="cpu", mesh=mesh)
    flat_j = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(
        jtree)[0]}
    flat_t = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(
        params)[0]}
    assert flat_j.keys() == flat_t.keys()
    for k, leaf in flat_j.items():
        assert tuple(flat_t[k].shape) == leaf.shape, k
    assert params["layers"]["wq"].shape[-1] == 8 * 8 and params["embed"].shape[0] == 512
    assert tcfg.num_params(mesh) == jcfg.num_params(mesh) == sum(
        t.numel() for t in flat_t.values())
    lyr = params["layers"]
    assert 0.9 < float(lyr["xd"].std()) * math.sqrt(F) < 1.1
    assert 0.9 < float(lyr["router"].std()) * math.sqrt(32) < 1.1


def test_padded_heads_are_not_inert():
    """arctic_480b.py:7-9 says padded heads have zero-initialised wo rows,
    but transformer.py:122 draws wo over all Hp heads: at tp 4, 6 heads pad
    to 8 and the 2 padded heads' wo rows and q columns are drawn like the
    others, in the reference and in the port.  So a padded head adds to the
    residual: at position 0 (one cached row) its attention output is its KV
    head's v row, and that row times the head's wo rows is not zero."""
    jcfg = JT.TransformerConfig(**dict(TINY, n_heads=6))
    mesh = AbstractMesh((2, 4), ("data", "model"))
    jp = JT.init_params(jcfg, jax.random.key(0), mesh)
    tcfg = T.TransformerConfig(**dict(TINY, n_heads=6))
    tp = T.init_params(tcfg, seed=0, device="cpu", mesh=mesh)
    dh = jcfg.d_head
    for wo, wq in ((np.asarray(jp["layers"]["wo"]), np.asarray(jp["layers"]["wq"])),
                   (tp["layers"]["wo"].numpy(), tp["layers"]["wq"].numpy())):
        assert wo.shape[1] == 8 * dh
        padded_wo, padded_wq = wo[:, 6 * dh:], wq[:, :, 6 * dh:]
        assert np.all(padded_wo != 0) and np.all(padded_wq != 0)
        v_row = np.ones((dh,), np.float32)  # any nonzero v row of the head's KV head
        assert np.abs(v_row @ padded_wo[0, :dh]).max() > 0
