"""repro_torch's LM serving path (models/transformer.py, the norm and rotary
layers, configs/stablelm_3b.py) against the JAX package on the CPU.

The reference's weights are carried across with ``params_from_numpy``; the
same numpy-seeded tokens go through both.  Tolerances: 1e-5 for the layers
(elementwise f32), 1e-4 for f32-compute logits and caches after a few
layers (sums in different orders), and a few bf16 ulps for bf16 compute
(see ``test_bf16_compute_matches_jax``).
On the CPU attention takes the plain versions of K6/K7; chip_smoke.py runs
the same path on the card through the kernels.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_common import LM_SHAPES as JAX_LM_SHAPES
from repro.configs.stablelm_3b import CONFIG as JAX_STABLELM
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.lm_common import LM_SHAPES, serving_config
from repro_torch.configs.stablelm_3b import make_config
from repro_torch.kernels import flash_attention as K6
from repro_torch.kernels import flash_decode as K7
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TINY = dict(name="tiny", n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
            vocab=128, d_head=12)  # tests/test_models.py::_tiny_cfg


def _configs(compute=jnp.float32, **kw):
    jdt_to_t = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    jcfg = JT.TransformerConfig(**TINY, compute_dtype=compute, remat_groups=3, **kw)
    tcfg = T.TransformerConfig(**TINY, compute_dtype=jdt_to_t[compute], **kw)
    return jcfg, tcfg


def _carry(jcfg, tcfg, seed=0):
    """The reference's params and the port's copy of them.  The init's qkv
    biases are zero: give them numpy-seeded values, so that they are carried."""
    jparams = JT.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in jparams["layers"]:
            b = rng.normal(size=np.shape(jparams["layers"][name])) * 0.1
            jparams["layers"][name] = jnp.asarray(b, jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, T.params_from_numpy(tcfg, np_params, "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
def test_rms_norm_matches_jax(dtypes, rng):
    jdt, tdt = dtypes
    x = rng.normal(size=(3, 5, 80)).astype(np.float32) * 3
    w = rng.normal(size=(80,)).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-5)
    got = L.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), 1e-5)
    assert got.dtype == tdt
    # f32: 1e-5; bf16: one bf16 ulp of the output where rounding ties differ.
    _close(got, want, 1e-5 if tdt == torch.float32 else 1e-2)


@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("dh", [12, 80, 128])
def test_apply_rope_matches_jax(theta, dh, rng):
    """Positions up to 32,767 (the decode_32k cache), half-split rotation."""
    B, S, H = 2, 9, 3
    x = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    pos = rng.integers(0, 32768, (B, S)).astype(np.int32)
    pos[0, 0], pos[1, -1] = 0, 32767
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(L.rope_frequencies(dh, theta),
                                  JL.rope_frequencies(dh, theta))


def test_kv_cache_update_matches_jax(rng):
    cache = rng.normal(size=(2, 10, 3, 8)).astype(np.float32)
    new = rng.normal(size=(2, 3, 8)).astype(np.float32)
    for pos in (4, 0, 9, 10, 12, -1):  # in range and not
        want = JL.kv_cache_update_shard(jnp.asarray(cache), jnp.asarray(new),
                                        jnp.asarray(pos, jnp.int32),
                                        jnp.zeros((), jnp.int32))
        got_t = torch.from_numpy(cache.copy())
        out = L.kv_cache_update_shard(got_t, torch.from_numpy(new),
                                      torch.tensor(pos, dtype=torch.int32))
        assert out is got_t  # in place
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


def test_vocab_embed_matches_jax(rng, monkeypatch):
    table = rng.normal(size=(40, 16)).astype(np.float32)
    tok = rng.integers(0, 40, (3, 7)).astype(np.int32)
    want = JL.sharded_vocab_embed(jnp.asarray(table), jnp.asarray(tok), None,
                                  out_dtype=jnp.float32)
    got = L.sharded_vocab_embed(torch.from_numpy(table), torch.from_numpy(tok), None,
                                out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Under a mesh each `model` rank gathers the rows of its block, zeroes
    # the others and all-reduces: with the all-reduce replaced by the sum
    # over the 4 ranks' outputs, the whole gather again (the spawn of
    # tests/test_torch_sharded.py runs the real collective).
    monkeypatch.setattr(M, "reduce_from", lambda x, axes, mesh: x)
    parts = [L.sharded_vocab_embed(torch.from_numpy(table[10 * r:10 * (r + 1)]),
                                   torch.from_numpy(tok), types.SimpleNamespace(
                                       coords={"data": 0, "model": r}),
                                   out_dtype=torch.float32) for r in range(4)]
    assert all(int((p != 0).any(-1).sum()) == int(((tok // 10) == r).sum())
               for r, p in enumerate(parts))
    np.testing.assert_array_equal(sum(parts).numpy(), np.asarray(want))


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["nobias", "bias"])
def test_forward_and_prefill_match_jax(qkv_bias, rng):
    jcfg, tcfg = _configs(qkv_bias=qkv_bias)
    jparams, tparams = _carry(jcfg, tcfg)
    toks = rng.integers(0, jcfg.vocab, (2, 11)).astype(np.int32)
    jl, _ = JT.forward(jcfg, jparams, jnp.asarray(toks), None)
    tl, aux = T.forward(tcfg, tparams, torch.from_numpy(toks))
    assert tl.shape == (2, 11, tcfg.padded_vocab()) and float(aux) == 0.0
    _close(tl, jl, 1e-4)
    jlast, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks), None)
    tlast, (tk, tv) = T.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert tk.shape == (3, 2, 11, 2, 12)
    _close(tlast, jlast, 1e-4)
    _close(tk, jk, 1e-4)
    _close(tv, jv, 1e-4)


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["nobias", "bias"])
def test_decode_steps_match_jax(qkv_bias, rng):
    """Prefill 8 tokens, pad the caches to 16, then two decode steps: logits
    and updated caches against the reference's."""
    jcfg, tcfg = _configs(qkv_bias=qkv_bias)
    jparams, tparams = _carry(jcfg, tcfg, seed=1)
    toks = rng.integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
    _, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :8]), None)
    pad = ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))
    jk, jv = jnp.pad(jk, pad), jnp.pad(jv, pad)
    _, (tk, tv) = T.prefill(tcfg, tparams, torch.from_numpy(toks[:, :8]))
    k_cache, v_cache = T.init_decode_cache(tcfg, 2, 16, device="cpu")
    k_cache[:, :, :8], v_cache[:, :, :8] = tk, tv
    cache = (k_cache, v_cache)
    for step in (8, 9):
        jlog, (jk, jv) = JT.decode_step(jcfg, jparams, (jk, jv), jnp.asarray(toks[:, step]),
                                        jnp.asarray(step, jnp.int32), None)
        tlog, cache = T.decode_step(tcfg, tparams, cache, torch.from_numpy(toks[:, step]),
                                    torch.tensor(step, dtype=torch.int32))
        assert cache[0] is k_cache  # updated in place
        _close(tlog, jlog, 1e-4)
        _close(cache[0], jk, 1e-4)
        _close(cache[1], jv, 1e-4)


def test_bf16_compute_matches_jax(rng):
    """bf16 activations (f32 weights): both sides round every matmul output
    and residual add to bf16, the reference's silu rounds twice (sigmoid,
    then the product), so after 3 layers values up to |x| ~ 4 differ by a
    few bf16 ulps (1.6e-2 each in [2, 4)): atol 6.25e-2 (four ulps), rtol
    3e-2.  Seeds 2-5 measured 2.7e-2 to 4.7e-2 on the CPU."""
    jcfg, tcfg = _configs(compute=jnp.bfloat16)
    jparams, tparams = _carry(jcfg, tcfg, seed=2)
    toks = rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    jlast, (jk, _) = JT.prefill(jcfg, jparams, jnp.asarray(toks), None)
    tlast, (tk, _) = T.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert tlast.dtype == torch.bfloat16 and tk.dtype == torch.bfloat16
    for got, want in ((tlast, jlast), (tk, jk)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=3e-2, atol=6.25e-2)


def test_decode_matches_forward(rng):
    """Inside the port: prefill 8, two decode steps, against one forward over
    all 10 tokens (tests/test_models.py::test_decode_matches_forward)."""
    _, cfg = _configs(qkv_bias=True)
    params = T.init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32))
    _, (kc, vc) = T.prefill(cfg, params, toks[:, :8])
    k_cache, v_cache = T.init_decode_cache(cfg, 2, 16, device="cpu")
    k_cache[:, :, :8], v_cache[:, :, :8] = kc, vc
    pos = torch.tensor(8, dtype=torch.int32)
    logits, cache = T.decode_step(cfg, params, (k_cache, v_cache), toks[:, 8], pos)
    logits2, _ = T.decode_step(cfg, params, cache, toks[:, 9], pos + 1)
    full, _ = T.forward(cfg, params, toks)
    v = cfg.vocab
    torch.testing.assert_close(logits[:, :v], full[:, -2, :v], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(logits2[:, :v], full[:, -1, :v], rtol=1e-4, atol=1e-4)


def test_cpu_path_never_launches(rng):
    _, cfg = _configs()
    params = T.init_params(cfg, device="cpu")
    before = (K6.launches, K7.launches)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 5)).astype(np.int32))
    _, (kc, vc) = T.prefill(cfg, params, toks)
    T.decode_step(cfg, params, (kc, vc), toks[:, -1], torch.tensor(4, dtype=torch.int32))
    assert (K6.launches, K7.launches) == before


def test_decode_step_takes_one_position():
    _, cfg = _configs()
    params = T.init_params(cfg, device="cpu")
    cache = T.init_decode_cache(cfg, 2, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="scalar"):
        T.decode_step(cfg, params, cache, torch.zeros(2, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------------------ configuration


def test_stablelm_3b_config_matches_jax():
    cfg = make_config()
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "d_head", "qkv_bias", "rope_theta", "norm_eps"):
        assert getattr(cfg, f) == getattr(JAX_STABLELM, f), f
    assert cfg.num_params() == JAX_STABLELM.num_params(None) == 2_795_276_800
    assert cfg.padded_heads() == JAX_STABLELM.padded_heads(None)
    assert cfg.padded_vocab() == JAX_STABLELM.padded_vocab(None)
    assert (cfg.param_dtype, cfg.compute_dtype) == (torch.float32, torch.bfloat16)
    serve = serving_config(cfg)
    assert (serve.param_dtype, serve.compute_dtype) == (torch.bfloat16, torch.bfloat16)
    assert LM_SHAPES == JAX_LM_SHAPES


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["nobias", "bias"])
def test_init_params_tree_matches_jax(qkv_bias):
    """Keys, shapes and dtypes equal the reference's tree; the scales follow
    it (normal / sqrt(fan_in), embed * 0.02, norms 1, biases 0)."""
    jcfg, tcfg = _configs(qkv_bias=qkv_bias)
    jtree = JT.abstract_params(jcfg, None)
    params = T.init_params(tcfg, seed=0, device="cpu")
    flat_j = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(jtree)[0]}
    flat_t = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    assert flat_j.keys() == flat_t.keys()
    for k, leaf in flat_j.items():
        assert tuple(flat_t[k].shape) == leaf.shape, k
        assert str(flat_t[k].dtype).split(".")[-1] == str(leaf.dtype), k
    # num_params counts no biases, in both packages.
    n_bias = sum(t.numel() for k, t in flat_t.items() if k[-4:-2] in ("bq", "bk", "bv"))
    assert tcfg.num_params() == jcfg.num_params(None) == sum(
        t.numel() for t in flat_t.values()) - n_bias
    lyr = params["layers"]
    assert torch.equal(lyr["ln1"], torch.ones_like(lyr["ln1"]))
    std = float(lyr["wd"].std()) * np.sqrt(tcfg.d_ff)
    assert 0.8 < std < 1.2
    assert 0.015 < float(params["embed"].std()) < 0.025
    bf = T.init_params(dataclasses.replace(tcfg, param_dtype=torch.bfloat16), device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in jax.tree_util.tree_leaves(bf))


def test_params_from_numpy_checks_the_layer_count():
    jcfg, tcfg = _configs()
    np_params = jax.tree_util.tree_map(np.asarray, JT.init_params(jcfg, jax.random.key(0)))
    with pytest.raises(ValueError, match="stacks 3 layers"):
        T.params_from_numpy(dataclasses.replace(tcfg, n_layers=2), np_params, "cpu")
