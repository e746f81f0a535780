"""repro_torch's LM training path against the JAX package, on the CPU.

Covered: the plain versions of K6's logsumexp and of its backward K6'
against ``jax.vjp`` of ``repro.models.layers.gqa_prefill_attention`` (K6'
has no Pallas counterpart: the reference trains through XLA's autodiff of
that jnp attention); ``lm_loss``; ``loss_and_grads`` and ``make_train_step``
(remat, microbatches, bf16_grads) against ``jax.value_and_grad`` and the
reference's step; the ports of tests/test_models.py's LM training tests and
tests/test_system.py's driver smoke; ``launch.train --model lm``; the card's
autograd wiring (``ops._is_cuda`` forced, the plain versions counted as K6
and K6'); the K6 and K6' wrappers' launch arguments and refusals with the
library faked; the LM registry's cells against the reference's on both
production meshes and its smoke on the CPU.

Weights come from the reference's ``jax.random`` init and cross over with
``params_from_numpy``; inputs are seeded numpy.  Tolerances (f32 on both
sides, sums in other orders):
  * attention and its gradients: 2e-5 (the reference's flash tolerance);
  * loss and every gradient leaf: rtol 1e-5, atol 1e-6 times the leaf's
    largest magnitude where that passes 1 (a gradient of ~10 sums terms of
    that size, and an element near 0 carries their rounding);
  * losses of several optimizer steps: rtol 1e-4 (each step's rounding
    differences feed the next);
  * tests/test_models.py's microbatch test keeps its own (rtol 2e-4, atol
    2e-5 on the params, 1e-5 on the loss).
"""
import argparse
import contextlib
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import abstract_mesh
from repro.data import synthetic as jsyn
from repro.launch import train as jtrain
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.moe import MoEConfig as JMoEConfig
from repro.optim import optimizers as JO
from repro_torch import configs
from repro_torch.configs import lm_common as LC
from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as K6
from repro_torch.kernels import flash_decode as K7
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import PRODUCTION_SHAPES, AbstractMesh
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEConfig
from repro_torch.optim import optimizers as O
from repro_torch.utils import keystr, tree_flatten_with_path, tree_map, tree_unflatten

ATTN_TOL = 2e-5
RTOL, ATOL = 1e-5, 1e-6
STEPS_RTOL = 1e-4
LM_IDS = ["arctic-480b", "llama3-405b", "olmoe-1b-7b", "qwen2-72b", "stablelm-3b"]

# tests/test_models.py::_tiny_cfg, and a tiny MoE with the dense residual
TINY = dict(name="tiny", n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
            vocab=128, d_head=12, remat_groups=3)
TINY_MOE = dict(num_experts=4, top_k=2, d_ff=32, capacity_factor=1.25)


def _configs(moe=False, **kw):
    jkw, tkw = dict(TINY, **kw), dict(TINY, **kw)
    if moe:
        jkw.update(moe=JMoEConfig(**TINY_MOE), moe_dense_residual=True)
        tkw.update(moe=MoEConfig(**TINY_MOE), moe_dense_residual=True)
    jcfg = JT.TransformerConfig(compute_dtype=jnp.float32, **jkw)
    tcfg = T.TransformerConfig(compute_dtype=torch.float32, **tkw)
    return jcfg, tcfg


def _carry(jcfg, tcfg, seed=0):
    """The reference's params (qkv biases given numpy-seeded values, so
    that they are carried) and the port's copy of them."""
    jparams = JT.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in jparams["layers"]:
            b = rng.normal(size=np.shape(jparams["layers"][name])) * 0.1
            jparams["layers"][name] = jnp.asarray(b, jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, T.params_from_numpy(tcfg, np_params, "cpu")


def _batch(vocab, B=4, S=16, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    b = jsyn.lm_batch(rng, vocab, B, S)
    if masked:
        b["labels"][0, :3] = -1
        b["labels"][1, -1] = -1
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_loss_and_grads(jcfg, jparams, b):
    def loss_fn(p):
        logits, aux = JT.forward(jcfg, p, jnp.asarray(b["tokens"]), None)
        return JT.lm_loss(jcfg, logits, jnp.asarray(b["labels"])) + aux

    return jax.value_and_grad(loss_fn)(jparams)


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    """Same keys in JAX's flatten order; each leaf allclose with atol times
    its largest magnitude past 1."""
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    tflat = tree_flatten_with_path(got)
    assert [keystr(p) for p, _ in tflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, t), (_, j) in zip(tflat, jflat):
        j = np.asarray(j, np.float32)
        t = t.detach().to(torch.float32).numpy()
        assert t.shape == j.shape, keystr(path)
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol * scale, err_msg=keystr(path))


# ------------------------------------------------- K6's lse and K6' (plain)


ATTN_CASES = [  # B, S, H, Hkv, dh, causal
    (2, 48, 4, 2, 16, True),
    (1, 40, 4, 4, 32, False),
    (2, 37, 4, 1, 80, True),  # ragged S, groups of 4
    (1, 45, 8, 2, 32, True),
    (1, 45, 2, 2, 16, False),
    (1, 33, 8, 1, 16, True),  # a group of 8
]


def _attn_inputs(B, S, H, Hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh), (B, S, H, dh))]


@pytest.mark.parametrize("B,S,H,Hkv,dh,causal", ATTN_CASES)
def test_flash_attention_backward_ref_matches_jax_vjp(B, S, H, Hkv, dh, causal):
    """The plain K6' (from the plain K6's output and logsumexp, blocks of 16
    keys and queries: ragged ends) and autograd of the plain forward against
    ``jax.vjp`` of the reference's attention."""
    q, k, v, do = _attn_inputs(B, S, H, Hkv, dh)
    jout, vjp = jax.vjp(lambda a, b_, c: JL.gqa_prefill_attention(a, b_, c, causal, 16),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal, q_block=16, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=ATTN_TOL, atol=ATTN_TOL)
    got = ref.flash_attention_backward_ref(tq, tk, tv, out, lse, tdo, causal, k_block=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=ATTN_TOL, atol=ATTN_TOL)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ops.flash_attention(*leaves, causal=causal).backward(tdo)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("B,S,H,Hkv,dh,causal", ATTN_CASES[:3])
def test_flash_attention_lse_is_m_plus_log_l(B, S, H, Hkv, dh, causal):
    """The plain K6's logsumexp against m + log l computed in numpy f64."""
    q, k, _, _ = _attn_inputs(B, S, H, Hkv, dh, seed=1)
    g = H // Hkv
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, g, axis=2).astype(np.float64)) / np.sqrt(dh)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    _, lse = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(k), causal, q_block=16, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def test_flash_attention_backward_ref_bf16_rounds_p_for_dv():
    """bf16 inputs: f32 arithmetic, outputs in bf16, dV from P rounded to
    bf16 as K6's P . V takes it (f64 holds the same algebra unrounded)."""
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(1, 24, 4, 2, 64))
    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    out, lse = ref.flash_attention_ref(*bf[:3], True, q_block=8, return_lse=True)
    got = ref.flash_attention_backward_ref(*bf[:3], out, lse, bf[3], True, k_block=8)
    f64 = [t.to(torch.float64) for t in bf]
    out64, lse64 = ref.flash_attention_ref(*f64[:3], True, return_lse=True)
    want = ref.flash_attention_backward_ref(*f64[:3], out.double(), lse64, f64[3], True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=3e-2, atol=3e-2)


# -------------------------------------------------------------- lm_loss


def test_lm_loss_matches_jax_with_masked_labels():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -1
    want = JT.lm_loss(None, jnp.asarray(logits), jnp.asarray(labels))
    got = T.lm_loss(None, torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full_like(labels, -1)
    assert float(T.lm_loss(None, torch.from_numpy(logits), torch.from_numpy(none))) == 0.0
    assert float(JT.lm_loss(None, jnp.asarray(logits), jnp.asarray(none))) == 0.0


# ------------------------------------------------ loss, gradients and steps


@pytest.mark.parametrize("moe", [False, True], ids=["dense_qkv_bias", "moe_dense_residual"])
def test_loss_and_grads_match_value_and_grad(moe):
    jcfg, tcfg = _configs(moe=moe, qkv_bias=not moe)
    jparams, tparams = _carry(jcfg, tcfg)
    b = _batch(jcfg.vocab)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, b)
    loss, grads = T.loss_and_grads(tcfg, tparams, torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, jgrads)


@pytest.mark.parametrize("moe,microbatches", [(False, 1), (False, 2), (True, 2)],
                         ids=["dense", "dense_mb2", "moe_mb2"])
def test_train_step_matches_reference(moe, microbatches):
    """One SGD step of the port's ``make_train_step`` against the
    reference's, jitted: loss and params."""
    jcfg, tcfg = _configs(moe=moe, microbatches=microbatches)
    jparams, tparams = _carry(jcfg, tcfg, seed=1)
    b = _batch(jcfg.vocab, seed=2)
    jopt, topt = JO.make_sgd(0.1), O.make_sgd(0.1)
    jp, _, jm = jax.jit(JT.make_train_step(jcfg, jopt, None))(jparams, jopt.init(jparams),
                                                               {k: jnp.asarray(v)
                                                                for k, v in b.items()})
    tp, _, tm = T.make_train_step(tcfg, topt)(tparams, topt.init(tparams), _torch_batch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    assert_trees_close(tp, jp)


def test_bf16_grads_step_matches_reference():
    """``bf16_grads``: the gradient through a bf16 copy of the matrices
    (compute in bf16), one SGD step, against the reference's at bf16's
    tolerance; the optimizer sees bf16 gradients for the matrices."""
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16, bf16_grads=True)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16, bf16_grads=True)
    jparams, tparams = _carry(jcfg, tcfg, seed=2)
    b = _batch(jcfg.vocab, seed=3)
    jopt = JO.make_sgd(0.1)
    seen = {}
    sgd = O.make_sgd(0.1)

    def update(grads, state, params):
        seen.update({keystr(p): g.dtype for p, g in tree_flatten_with_path(grads)})
        return sgd.update(grads, state, params)

    jp, _, jm = jax.jit(JT.make_train_step(jcfg, jopt, None))(
        jparams, jopt.init(jparams), {k: jnp.asarray(v) for k, v in b.items()})
    tp, _, tm = T.make_train_step(tcfg, O.Optimizer(sgd.init, update))(
        tparams, sgd.init(tparams), _torch_batch(b))
    assert seen["['layers']['wq']"] == torch.bfloat16 and seen["['final_ln']"] == torch.float32
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    assert_trees_close(tp, jp, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_remat_on_and_off_bit_equal(moe):
    """The two-level remat changes no bit of the loss or the gradients."""
    _, tcfg = _configs(moe=moe, remat_groups=1)
    _, tparams = _carry(*_configs(moe=moe))
    b = _torch_batch(_batch(tcfg.vocab))

    def grads(remat):
        leaves = [t.detach().requires_grad_(True) for _, t in tree_flatten_with_path(tparams)]
        params = tree_unflatten(tparams, leaves)
        x, aux, _ = T._hidden(tcfg, params, b["tokens"], False, remat)
        logits = x @ params["head"].to(tcfg.compute_dtype).T
        loss = T.lm_loss(tcfg, logits, b["labels"]) + aux
        return [loss] + list(torch.autograd.grad(loss, leaves))

    for a, c in zip(grads(True), grads(False)):
        assert torch.equal(a, c)


def test_groups_and_batch_axes_match_reference():
    for n_layers, remat in ((32, 0), (126, 0), (35, 7), (16, 4), (3, 3), (7, 0)):
        jcfg = JT.TransformerConfig(**dict(TINY, n_layers=n_layers, remat_groups=remat))
        tcfg = T.TransformerConfig(**dict(TINY, n_layers=n_layers, remat_groups=remat))
        assert tcfg.groups() == jcfg.groups()
    for multi_pod in (False, True):
        assert tcfg.batch_axes(multi_pod) == jcfg.batch_axes(multi_pod)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_mesh_cells_build_steps_that_take_their_blocks(arch_id, shape):
    """The train and prefill cells under a small (data 2, model 4)
    ``AbstractMesh``: nothing raises before a device is needed.  Every
    argument splits evenly under its spec, the params' specs are the
    layout the step takes (``mesh_param_specs``, against which
    ``make_train_step`` checks ``grad_specs`` when it is built), the batch
    is split by rows over the batch axes, and the optimizer state's specs
    are its state specs (Adafactor's under the mesh).  The steps run on
    gloo ranks in tests/test_torch_sharded.py."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    arch = configs.get(arch_id)
    cell = arch.build_cell(shape, mesh, False)
    args = tree_flatten_with_path(cell.args)
    specs = [s for _, s in tree_flatten_with_path(cell.in_shardings, lambda x: isinstance(x, P))]
    assert len(args) == len(specs)
    for (path, t), spec in zip(args, specs):
        assert t.device.type == "meta"
        for d, n in enumerate(t.shape):
            axes = spec.axes_of(d)
            assert n % (mesh.axis_size(axes) if axes else 1) == 0, (keystr(path), d, spec)
    base, kw = arch.build_cell.keywords["base_cfg"], arch.build_cell.keywords
    if shape == "train_4k":
        cfg = dataclasses.replace(base, param_dtype=torch.float32)
    else:
        cfg = dataclasses.replace(base, param_dtype=torch.bfloat16, fsdp=kw["fsdp_serve"])
    layout = T.mesh_param_specs(cfg, mesh, ("data",))
    assert cell.in_shardings[0] == layout
    assert cell.in_shardings[-1] == ({"tokens": P(("data",), None), "labels": P(("data",), None)}
                                     if shape == "train_4k" else P(("data",), None))
    if shape == "train_4k":
        state_specs = LC.make_optimizer(kw["opt_kind"])[1](layout, cell.args[0])
        assert cell.in_shardings[1] == state_specs
        T.make_train_step(cfg, LC.make_optimizer(kw["opt_kind"], mesh, layout)[0], mesh,
                          ("data",), grad_specs=layout)
    other = T.mesh_param_specs(dataclasses.replace(cfg, fsdp=not cfg.fsdp), mesh, ("data",))
    with pytest.raises(ValueError, match="the gradients take the params' layout"):
        T.make_train_step(cfg, O.make_sgd(0.1), mesh, ("data",), grad_specs=other)


def test_in_place_adam_equals_functional():
    """``make_adam(in_place=True)`` gives the functional update's bits and
    writes them into the tensors it was given."""
    _, tparams = _carry(*_configs())
    rng = np.random.default_rng(5)
    grads = tree_map(lambda p: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)),
                       tparams)
    fn, ip = O.make_adam(1e-3), O.make_adam(1e-3, in_place=True)
    want_p, want_s = tparams, fn.init(tparams)
    got_p = tree_map(torch.clone, tparams)
    got_s = ip.init(got_p)
    for _ in range(2):
        want_p, want_s = fn.update(grads, want_s, want_p)
        before = [t.data_ptr() for _, t in tree_flatten_with_path((got_p, got_s["m"]))]
        got_p, got_s = ip.update(grads, got_s, got_p)
        assert [t.data_ptr() for _, t in tree_flatten_with_path((got_p, got_s["m"]))] == before
    for (path, a), (_, c) in zip(tree_flatten_with_path((got_p, got_s)),
                                 tree_flatten_with_path((want_p, want_s))):
        assert torch.equal(a, c), (keystr(path), float((a.double() - c.double()).abs().max()))


# ------------------------------------- the reference's LM training tests


def test_lm_loss_decreases():
    """tests/test_models.py::test_lm_loss_decreases with the reference's
    weights: Adam 3e-3, one batch, 8 steps; the losses are the reference's."""
    jcfg, tcfg = _configs()
    jparams, tparams = _carry(jcfg, tcfg, seed=1)
    b = jsyn.lm_batch(np.random.default_rng(0), jcfg.vocab, 8, 16)
    jopt, topt = JO.make_adam(3e-3), O.make_adam(3e-3)
    jstep = jax.jit(JT.make_train_step(jcfg, jopt, None))
    tstep = T.make_train_step(tcfg, topt)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jb, tb = {k: jnp.asarray(v) for k, v in b.items()}, _torch_batch(b)
    jl, tl = [], []
    for _ in range(8):
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=STEPS_RTOL)
    assert tl[-1] < tl[0]


def test_microbatched_grads_match():
    """tests/test_models.py::test_microbatched_grads_match in the port (its
    tolerances), and each side against the reference's."""
    jcfg, tcfg = _configs()
    jparams, tparams = _carry(jcfg, tcfg, seed=2)
    b = jsyn.lm_batch(np.random.default_rng(0), jcfg.vocab, 8, 16)
    opt = O.make_sgd(0.1)
    p1, _, m1 = T.make_train_step(tcfg, opt)(tparams, opt.init(tparams), _torch_batch(b))
    tcfg4 = dataclasses.replace(tcfg, microbatches=4)
    p2, _, m2 = T.make_train_step(tcfg4, opt)(tparams, opt.init(tparams), _torch_batch(b))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for (_, a), (_, c) in zip(tree_flatten_with_path(p1), tree_flatten_with_path(p2)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-4, atol=2e-5)
    jopt = JO.make_sgd(0.1)
    jcfg4 = dataclasses.replace(jcfg, microbatches=4)
    jp2, _, jm2 = jax.jit(JT.make_train_step(jcfg4, jopt, None))(
        jparams, jopt.init(jparams), {k: jnp.asarray(v) for k, v in b.items()})
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), rtol=RTOL)
    assert_trees_close(p2, jp2)


def test_train_driver_smoke(monkeypatch):
    """tests/test_system.py::test_train_driver_smoke: ``train_lm`` for 6
    steps of 8 x 16 tokens, from the reference's init of lm-small (seed 0,
    carried across in place of the port's own init), gives the reference's
    losses, and the last is lower."""
    args = argparse.Namespace(steps=6, batch=8, seq=16, seed=0, log_every=5, device="cpu")
    want = jtrain.train_lm(args)
    jcfg = jtrain.make_lm_small()
    np_params = jax.tree_util.tree_map(np.asarray, JT.init_params(jcfg, jax.random.key(0)))
    monkeypatch.setattr(ttrain.T, "init_params",
                        lambda cfg, seed, device: T.params_from_numpy(cfg, np_params, device))
    out = ttrain.train_lm(args)
    np.testing.assert_allclose([out["first_loss"], out["final_loss"]],
                               [want["first_loss"], want["final_loss"]], rtol=STEPS_RTOL)
    assert out["steps"] == 6 and out["final_loss"] < out["first_loss"]


def test_make_lm_small_matches_reference():
    jcfg, tcfg = jtrain.make_lm_small(), ttrain.make_lm_small()
    for f in dataclasses.fields(jcfg):
        if f.name not in ("param_dtype", "compute_dtype", "moe"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.param_dtype, tcfg.compute_dtype) == (torch.float32, torch.float32)


def test_launch_train_lm_on_the_cpu():
    """``launch.train --model lm --device cpu``: lm-small trains 6 steps of
    8 x 16 tokens with finite losses.  Whether the loss falls in 6 steps on
    lm_batch's labels, drawn apart from the tokens, is a coin toss in both
    packages (ROADMAP, Quirks), so ``main``'s closing assert is not held
    here."""
    argv = ["--model", "lm", "--device", "cpu", "--steps", "6", "--batch", "8", "--seq", "16"]
    args = ttrain.parse_args(argv)
    assert (args.model, args.seq, args.device) == ("lm", 16, "cpu")
    assert ttrain.parse_args(["--model", "lm"]).seq == 128
    out = ttrain.train_lm(args)
    assert out["steps"] == 6 and len(out["losses"]) == 6
    assert all(np.isfinite(out["losses"]))


# ------------------------------------------------- the card's autograd wiring


@pytest.fixture
def k6_route(monkeypatch):
    """The card's autograd path on the CPU: ``ops`` takes every tensor for a
    CUDA one, and K6 (with and without its logsumexp) and K6' are their plain
    versions, counted."""
    calls = {"K6": 0, "K6 lse": 0, "K6'": 0}

    def k6(q, k, v, causal=True, lse=None):
        calls["K6"] += 1
        out, row_lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
        if lse is not None:
            calls["K6 lse"] += 1
            lse.copy_(row_lse)
        return out

    def k6b(q, k, v, o, lse, do, causal=True):
        calls["K6'"] += 1
        return ref.flash_attention_backward_ref(q, k, v, o, lse, do, causal)

    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    monkeypatch.setattr(K6, "flash_attention", k6)
    monkeypatch.setattr(K6, "flash_attention_backward", k6b)
    return calls


@pytest.mark.parametrize("moe,groups", [(False, 3), (False, 1), (True, 3)],
                         ids=["dense_g3", "dense_g1", "moe_g3"])
def test_card_autograd_wiring(moe, groups, k6_route):
    """Through ``ops._FlashAttention`` (K6 with its logsumexp, K6'), the loss
    and every gradient leaf equal the reference's, wq/wk/wv included (a K6
    output that autograd detached would leave them without the attention's
    part); K6 runs 3 L - G times a step under the two-level remat (forward,
    each group's recompute up to its last layer, each layer's), K6' L times."""
    jcfg, tcfg = _configs(moe=moe, remat_groups=groups)
    jparams, tparams = _carry(jcfg, tcfg)
    b = _batch(jcfg.vocab)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, b)
    loss, grads = T.loss_and_grads(tcfg, tparams, torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]))
    L_ = tcfg.n_layers
    assert k6_route == {"K6": 3 * L_ - groups, "K6 lse": 3 * L_ - groups, "K6'": L_}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, jgrads)
    for name in ("wq", "wk", "wv"):
        assert bool(grads["layers"][name].abs().sum(dim=(1, 2)).gt(0).all())
    with torch.no_grad():  # no gradient wanted: K6 without its logsumexp, no Function
        T.forward(tcfg, tparams, torch.from_numpy(b["tokens"]))
    assert k6_route == {"K6": 4 * L_ - groups, "K6 lse": 3 * L_ - groups, "K6'": L_}


def test_card_microbatches_launch_per_microbatch(k6_route):
    _, tcfg = _configs(microbatches=2)
    _, tparams = _carry(*_configs())
    opt = O.make_sgd(0.1)
    T.make_train_step(tcfg, opt)(tparams, opt.init(tparams), _torch_batch(_batch(128)))
    assert k6_route["K6'"] == 2 * tcfg.n_layers
    assert k6_route["K6"] == 2 * (3 * tcfg.n_layers - tcfg.groups())


# ------------------------------------------ K6 / K6' wrappers (library faked)


class _FakeLib:
    """A kernel library that records each launch's symbol and arguments."""

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
                        lambda *a: types.SimpleNamespace(cuda_stream=55))
    before = (K6.launches, K6.launches_f32, K6.launches_bwd, K6.launches_bwd_f32)
    yield lib
    K6.launches, K6.launches_f32, K6.launches_bwd, K6.launches_bwd_f32 = before


def _qkv(B=2, S=24, H=4, Hkv=2, dh=16, dtype=torch.float32):
    return (torch.zeros(B, S, H, dh, dtype=dtype), torch.zeros(B, S, Hkv, dh, dtype=dtype),
            torch.zeros(B, S, Hkv, dh, dtype=dtype))


@pytest.mark.parametrize("dh", [16, 32])
def test_flash_attention_f32_takes_small_head_dims_and_lse(fake_lib, dh):
    q, k, v = _qkv(dh=dh)
    lse = torch.empty(2, 4, 24)
    K6.flash_attention(q, k, v, True, lse=lse)
    K6.flash_attention(q, k, v, False)
    (sym, a), (_, b) = fake_lib.calls
    assert sym == "flash_attention_f32" and a[4:10] == (2, 24, 4, 2, dh, 1)
    assert a[11] == 55 and a[12] == lse.data_ptr() and b[12] is None


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 16), (torch.float32, 80),
                                      (torch.bfloat16, 64), (torch.bfloat16, 128),
                                      (torch.bfloat16, 16), (torch.bfloat16, 32)])
def test_flash_attention_backward_launch_arguments(fake_lib, dtype, dh):
    """Pointers, shapes, the 15 strides of q, k, v, o and do (k a view of a
    wider tensor: its own strides, uncopied), the stream; new contiguous
    outputs in q's dtype and an f32 [B, H, S] scratch; the launch counted."""
    B, S, H, Hkv = 2, 24, 4, 2
    q = torch.zeros(B, S, H, dh, dtype=dtype)
    k = torch.zeros(B, S, Hkv, 2 * dh, dtype=dtype)[..., :dh]
    v = torch.zeros(B, S, Hkv, dh, dtype=dtype)
    o, do = torch.zeros_like(q), torch.zeros_like(q)
    lse = torch.zeros(B, H, S)
    before = (K6.launches_bwd, K6.launches_bwd_f32)
    dq, dk, dv = K6.flash_attention_backward(q, k, v, o, lse, do, False)
    ((sym, a),) = fake_lib.calls
    assert sym == f"flash_attention_backward_{'f32' if dtype == torch.float32 else 'bf16'}"
    assert a[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr())
    assert a[7:10] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert a[10:16] == (B, S, H, Hkv, dh, 0) and a[17] == 55
    assert list(a[16]) == [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           *o.stride()[:3], *do.stride()[:3]]
    for t, shape in ((dq, q.shape), (dk, v.shape), (dv, v.shape)):
        assert t.dtype == dtype and t.shape == shape and t.is_contiguous()
    assert (K6.launches_bwd, K6.launches_bwd_f32) == (
        before[0] + 1, before[1] + (dtype == torch.float32))


@pytest.mark.parametrize("case,exc,match", [
    ("bf16_dh48", ValueError, "head dim 48"),
    ("lse_shape", ValueError, "lse"),
    ("lse_dtype", ValueError, "lse"),
    ("o_shape", ValueError, "must match q"),
    ("do_strides", ValueError, "strides"),
])
def test_flash_attention_backward_refuses_bad_input(fake_lib, case, exc, match):
    dtype = torch.bfloat16 if case == "bf16_dh48" else torch.float32
    q, k, v = _qkv(dtype=dtype, dh=48 if case == "bf16_dh48" else 16)
    o, do, lse = torch.zeros_like(q), torch.zeros_like(q), torch.zeros(2, 4, 24)
    if case == "lse_shape":
        lse = torch.zeros(2, 24, 4)
    elif case == "lse_dtype":
        lse = torch.zeros(2, 4, 24, dtype=torch.float64)
    elif case == "o_shape":
        o = o[:, :12]
    elif case == "do_strides":
        do = torch.zeros(2, 24, 4, 32)[..., ::2]
    with pytest.raises(exc, match=match):
        K6.flash_attention_backward(q, k, v, o, lse, do, True)
    assert not fake_lib.calls


def test_flash_attention_lse_and_cpu_refusals():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="CUDA"):
        K6.flash_attention_backward(q, k, v, q, torch.zeros(2, 4, 24), q, True)
    # bf16 at dh 32 passes the checks and is refused for lying on the CPU; a
    # head dim outside the set is refused for itself
    with pytest.raises(ValueError, match="CUDA"):
        K6.flash_attention(*_qkv(dh=32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="head dim 48"):
        K6.flash_attention(*_qkv(dh=48, dtype=torch.bfloat16))


def test_flash_decode_f32_takes_small_head_dims():
    """K7 takes head dims 16 and 32 (lm_smoke's and lm-small's decode on
    the card) in f32 and in bf16; 48 stays refused in both."""
    for dtype, dh, ok in ((torch.float32, 16, True), (torch.float32, 32, True),
                          (torch.bfloat16, 16, True), (torch.bfloat16, 32, True),
                          (torch.float32, 48, False), (torch.bfloat16, 48, False)):
        args = (torch.zeros(2, 4, dh, dtype=dtype), torch.zeros(2, 8, 2, dh, dtype=dtype),
                torch.zeros(2, 8, 2, dh, dtype=dtype), torch.tensor(3, dtype=torch.int32))
        ctx = contextlib.nullcontext() if ok else pytest.raises(ValueError, match="head dim")
        with ctx:
            K7.check_inputs(*args)


def test_backward_symbols_exist_in_source():
    """Every C function the K6' wrapper binds is exported by its source, and
    the source instantiates exactly the head dims the wrapper accepts."""
    src = (build.CSRC / f"{K6.NAME_BWD}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(K6._SYMBOLS_BWD.values()) | {f"{K6.NAME_BWD}_error_string"} <= exported
    assert {int(d) for d in re.findall(r"case (\d+):", src)} == set().union(
        *K6.HEAD_DIMS.values())
    assert re.fullmatch(rf"lib{K6.NAME_BWD}-[0-9a-f]{{16}}\.so",
                        build.library_path(K6.NAME_BWD).name)


# ------------------------------------------------------------- registry


def _spec_axes(spec, ndim):
    """Per dimension, the mesh axes a spec splits it over (jax or port)."""
    out = []
    for d in range(ndim):
        el = spec[d] if d < len(spec) else None
        out.append(() if el is None else (el,) if isinstance(el, str) else tuple(el))
    return out


def test_registry_lists_the_lm_archs():
    assert set(LM_IDS) <= set(configs.list_archs())
    # the GNN, the last id the port lacked, is registered as the reference's
    gnn, jgnn = configs.get("graphsage-reddit"), jconfigs.get("graphsage-reddit")
    assert (gnn.kind, gnn.shapes, gnn.notes) == (jgnn.kind, jgnn.shapes, jgnn.notes) and \
        gnn.kind == "gnn"
    assert configs.list_archs() == jconfigs.list_archs()
    for arch_id in LM_IDS:
        arch, jarch = configs.get(arch_id), jconfigs.get(arch_id)
        assert (arch.kind, arch.shapes, arch.notes) == (jarch.kind, jarch.shapes, jarch.notes)
        assert arch.shapes == tuple(LC.LM_SHAPES)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_configs_match_reference(arch_id):
    mod = arch_id.replace("-", "_")
    jcfg = getattr(jconfigs, mod).CONFIG
    tcfg = getattr(configs, mod).make_config()
    for f in dataclasses.fields(jcfg):
        if f.name not in ("param_dtype", "compute_dtype", "moe"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (jcfg.moe is None) == (tcfg.moe is None)
    if jcfg.moe is not None:
        assert dataclasses.asdict(jcfg.moe) == dataclasses.asdict(tcfg.moe)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi_pod"])
@pytest.mark.parametrize("shape", list(LC.LM_SHAPES))
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_build_lm_cell_matches_reference(arch_id, shape, multi_pod):
    """The cell's arguments (meta tensors: no allocation) and in_shardings
    against the reference's ``build_cell`` on the production mesh."""
    want = jconfigs.get(arch_id).build_cell(
        shape, abstract_mesh(*PRODUCTION_SHAPES[multi_pod]), multi_pod)
    got = configs.get(arch_id).build_cell(shape, AbstractMesh(*PRODUCTION_SHAPES[multi_pod]),
                                          multi_pod)
    assert got.step_name == want.step_name and got.donate_argnums == want.donate_argnums
    jargs, _ = jax.tree_util.tree_flatten_with_path(want.args)
    targs = tree_flatten_with_path(got.args)
    assert [keystr(p) for p, _ in targs] == [jax.tree_util.keystr(p) for p, _ in jargs]
    for (_, t), (_, j) in zip(targs, jargs):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape) and str(t.dtype)[6:] == str(j.dtype)
    jspecs = jax.tree_util.tree_leaves(
        want.in_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tspecs = [s for _, s in tree_flatten_with_path(got.in_shardings,
                                                   lambda x: isinstance(x, P))]
    assert len(tspecs) == len(jspecs) == len(targs)
    for t, j, (path, leaf) in zip(tspecs, jspecs, targs):
        assert _spec_axes(t, leaf.ndim) == _spec_axes(j, leaf.ndim), keystr(path)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_smoke_on_the_cpu(arch_id):
    out = configs.get(arch_id).smoke("cpu")
    assert np.isfinite(out["loss"]) and out["logits_shape"] == (4, 256)
