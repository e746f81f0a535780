"""The LM in bf16 compute at lm-small's and lm_smoke's widths: the port
against the reference on the CPU, with the reference's params carried
across.

The reference's ``TransformerConfig`` computes in bf16 by default, and its
two small LM configs sit at head dims 32 (lm-small,
``repro/launch/train.py::make_lm_small``) and 16 (the registry's smoke cut,
``repro/configs/lm_common.py::lm_smoke``, here of qwen2-72b: 4 query heads
over 1 KV head, QKV bias).  Both are taken with bf16 compute, as the card
runs them (chip_smoke.py's ``lm_small_bf16`` phase), and held at:

  * prefill logits and caches, 8 teacher-forced decode steps' logits and
    the caches after them: rtol 3e-2, atol 6.25e-2, the tolerances of
    ``tests/test_torch_transformer.py::test_bf16_compute_matches_jax``
    (both sides round every matmul output and residual add to bf16, in
    other sum orders, and the reference's silu rounds twice);
  * one train step's loss at rtol 3e-2, and every gradient leaf at rtol
    3e-2 and atol 6.25e-2 times the leaf's largest magnitude: the same
    tolerances on the leaf's own scale (its values lie far below 1; the
    worst leaf measured 2.6e-2 of its largest magnitude, lm-small's wk).

On the CPU the attention runs the plain versions of K6, K6' and K7; the
kernels at these head dims are held against those on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_72b as jqwen2
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro_torch.configs import lm_common as LC
from repro_torch.configs import qwen2_72b as tqwen2
from repro_torch.kernels import flash_attention as K6
from repro_torch.kernels import flash_decode as K7
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.utils import keystr, tree_flatten_with_path

RTOL, ATOL = 3e-2, 6.25e-2
CONFIGS = ["lm-small", "lm_smoke"]


def _jax_smoke(base):
    """The reference's smoke cut (``repro/configs/lm_common.py::lm_smoke``)."""
    return dataclasses.replace(
        base, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, base.n_kv_heads * 4 // base.n_heads), d_head=16, d_ff=128,
        vocab=256, moe=None, param_dtype=jnp.float32, compute_dtype=jnp.float32,
        seq_shard=False, remat_groups=2, fsdp=False, q_block=8)


def _configs(which: str):
    if which == "lm-small":
        jcfg, tcfg = jtrain.make_lm_small(), ttrain.make_lm_small()
    else:
        jcfg, tcfg = _jax_smoke(jqwen2.CONFIG), LC.smoke_config(tqwen2.make_config())
    return (dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16),
            dataclasses.replace(tcfg, compute_dtype=torch.bfloat16))


def _carry(jcfg, tcfg, seed=0):
    """The reference's init (QKV biases given seeded values, so that they
    are carried) and the port's copy of it."""
    jparams = JT.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in jparams["layers"]:
            b = rng.normal(size=np.shape(jparams["layers"][name])) * 0.1
            jparams["layers"][name] = jnp.asarray(b, jnp.float32)
    return jparams, T.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _close(got: torch.Tensor, want, name: str, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=atol, err_msg=name)


@pytest.mark.parametrize("which", CONFIGS)
def test_configs_are_the_references(which):
    """The two configs' fields, field by field: head dims 32 and 16, bf16
    compute, and the smoke cut's GQA (4 heads over 1) and QKV bias."""
    jcfg, tcfg = _configs(which)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head",
              "qkv_bias", "rope_theta", "norm_eps", "q_block", "seq_shard", "remat_groups",
              "fsdp", "microbatches", "bf16_grads"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.compute_dtype == torch.bfloat16 and tcfg.param_dtype == torch.float32
    assert tcfg.d_head in K6.HEAD_DIMS[torch.bfloat16] and tcfg.d_head in K7.HEAD_DIMS[
        torch.bfloat16]
    assert (tcfg.d_head, tcfg.n_heads // tcfg.n_kv_heads) == (
        (32, 2) if which == "lm-small" else (16, 4))


@pytest.mark.parametrize("which", CONFIGS)
def test_prefill_matches_reference(which):
    jcfg, tcfg = _configs(which)
    jparams, tparams = _carry(jcfg, tcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    jlast, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks), None)
    tlast, (tk, tv) = T.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert tlast.dtype == tk.dtype == torch.bfloat16
    for name, got, want in (("last logits", tlast, jlast), ("k", tk, jk), ("v", tv, jv)):
        _close(got, want, name)


@pytest.mark.parametrize("which", CONFIGS)
def test_decode_steps_match_reference(which):
    """Prefill 16 tokens into caches of 24, then 8 decode steps on the
    same tokens: each step's logits, then the caches."""
    jcfg, tcfg = _configs(which)
    jparams, tparams = _carry(jcfg, tcfg, seed=1)
    P, N = 16, 8
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, P + N)).astype(np.int32)
    _, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks[:, :P]), None)
    pad = ((0, 0), (0, 0), (0, N), (0, 0), (0, 0))
    jk, jv = jnp.pad(jk, pad), jnp.pad(jv, pad)
    _, (tk, tv) = T.prefill(tcfg, tparams, torch.from_numpy(toks[:, :P]))
    k_cache, v_cache = T.init_decode_cache(tcfg, 2, P + N, device="cpu")
    assert k_cache.dtype == torch.bfloat16
    k_cache[:, :, :P], v_cache[:, :, :P] = tk, tv
    cache = (k_cache, v_cache)
    for i in range(N):
        jlog, (jk, jv) = JT.decode_step(jcfg, jparams, (jk, jv), jnp.asarray(toks[:, P + i]),
                                        jnp.asarray(P + i, jnp.int32), None)
        tlog, cache = T.decode_step(tcfg, tparams, cache, torch.from_numpy(toks[:, P + i]),
                                    torch.tensor(P + i, dtype=torch.int32))
        _close(tlog, jlog, f"step {i} logits")
    _close(cache[0], jk, "k cache")
    _close(cache[1], jv, "v cache")


@pytest.mark.parametrize("which", CONFIGS)
def test_train_step_grads_match_reference(which):
    """One step's loss and every gradient leaf (f32 params, bf16 compute)
    against ``jax.value_and_grad`` of the reference's forward and loss."""
    jcfg, tcfg = _configs(which)
    jparams, tparams = _carry(jcfg, tcfg, seed=2)
    b = jsyn.lm_batch(np.random.default_rng(3), jcfg.vocab, 2, 32)
    b["labels"][0, :3] = -1

    def loss_fn(p):
        logits, aux = JT.forward(jcfg, p, jnp.asarray(b["tokens"]), None)
        return JT.lm_loss(jcfg, logits, jnp.asarray(b["labels"])) + aux

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    loss, grads = T.loss_and_grads(tcfg, tparams, torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    tflat = tree_flatten_with_path(grads)
    assert [keystr(p) for p, _ in tflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, g), (_, w) in zip(tflat, jflat):
        assert g.dtype == torch.float32 and tuple(g.shape) == np.shape(w), keystr(path)
        _close(g, w, keystr(path), ATOL * float(np.abs(np.asarray(w)).max()))
