"""repro_torch's training path against the JAX package, on the CPU.

Weights come from the reference's ``jax.random`` init and cross over with
``params_from_numpy``; batches are seeded numpy.  On the CPU the port's step
runs the plain forwards and autograd differentiates them; the autograd
Functions that carry K1/K1' and K2/K2' on the card are driven here with the
plain versions standing in for the kernels.  Tolerances (f32 on both sides,
summation orders differ: XLA's scatter-add and einsum against index_add_ and
bmm, ``lax.rsqrt`` against ``torch.rsqrt``):
  * loss and every gradient leaf: rtol 1e-5, atol 1e-6;
  * params and optimizer state after three steps: rtol 1e-5, atol 1e-6;
  * the backward plain versions against autograd: f64 1e-12; f32 1e-6 for
    K1', 1e-5 for K2' (the same products, summed in another order);
  * the last loss of the cross-package resume: rtol 1e-5 (the reference's
    restart check, tests/test_system.py).
"""
import argparse
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sharding import TableSpec as JaxTableSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import train as jtrain
from repro.models import recsys as JR
from repro.optim import optimizers as JO
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.kernels import dot_interaction as K2
from repro_torch.kernels import embedding_bag as K1
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as R
from repro_torch.optim import optimizers as O
from repro_torch.utils import keystr, tree_flatten_with_path

RTOL, ATOL = 1e-5, 1e-6
STEP_RTOL = 1e-5

# test_system.py's tiny DLRM; "mean_replicated" adds a mean-pooled field and
# replicates one field (params gain ['emb']['rep_table']).
SPECS = {
    "tiny": ([("big", 4000, 4, "sum"), ("mid", 1000, 1, "sum"), ("small", 64, 1, "sum")], ()),
    "mean_replicated": ([("big", 4000, 4, "sum"), ("bag", 300, 3, "mean"),
                         ("mid", 1000, 1, "sum"), ("small", 64, 1, "sum")], (3,)),
}


def _cfgs(name):
    specs, replicated = SPECS[name]
    kw = dict(name="t", arch="dlrm", embed_dim=16, n_dense=13, bottom_mlp=(64, 16),
              mlp=(64, 32), replicated_fields=replicated)
    jcfg = JR.RecsysConfig(
        tables=tuple(JaxTableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in specs), **kw)
    tcfg = R.RecsysConfig(
        tables=tuple(TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in specs), **kw)
    return jcfg, tcfg


def _optimizers():
    mix = lambda m: m.make_composite(  # noqa: E731
        [("emb", m.make_rowwise_adagrad(0.05)), (".*", m.make_adam(1e-3))])
    return mix(JO), mix(O)


def _nan_behind_padding(np_params, tcfg, batches):
    """NaN in every row of the fused table that only masked slots name."""
    emb = tcfg.embedding()
    table = np_params["emb"]["table"]
    live, dead = set(), set()
    for b in batches:
        fused = emb._fused_rows(emb.sharded, torch.from_numpy(
            b["indices"][:, list(emb.sharded_idx), :])).numpy()
        m = b["mask"][:, list(emb.sharded_idx), :]
        live |= set(fused[m].tolist())
        dead |= set(fused[~m].tolist())
    rows = sorted(dead - live)
    assert rows, "no row only padding names"
    table[rows] = np.nan
    return rows


def _setup(name, nan_padding=False, steps=1, batch=32):
    jcfg, tcfg = _cfgs(name)
    np_params = jax.tree_util.tree_map(np.array, JR.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(7)
    batches = [syn.recsys_batch(rng, tcfg.tables, batch, n_dense=13) for _ in range(steps)]
    if nan_padding:
        _nan_behind_padding(np_params, tcfg, batches)
    return jcfg, tcfg, np_params, batches


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_loss_and_grads(jcfg, np_params, b):
    def loss_fn(p):
        return JR.bce_loss(JR.forward(jcfg, p, _jax_batch(b), None), jnp.asarray(b["labels"]))
    return jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, np_params))


def assert_trees_close(got, want, rtol, atol):
    """Same key strings in the same order; leaves allclose, NaN where the
    reference has NaN."""
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    tflat = tree_flatten_with_path(got)
    assert [keystr(p) for p, _ in tflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, t), (_, j) in zip(tflat, jflat):
        assert t is not None, keystr(path)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol,
                                   err_msg=keystr(path))


CASES = [("tiny", False), ("mean_replicated", False), ("tiny", True)]
CASE_IDS = ["tiny", "mean_replicated", "nan_behind_padding"]


@pytest.mark.parametrize("name,nan_padding", CASES, ids=CASE_IDS)
def test_loss_and_grads_match_value_and_grad(name, nan_padding):
    jcfg, tcfg, np_params, (b,) = _setup(name, nan_padding)
    jloss, jgrads = _jax_loss_and_grads(jcfg, np_params, b)
    params = R.params_from_numpy(np_params, "cpu")
    loss, grads = R.loss_and_grads(tcfg, params, _torch_batch(b))
    assert loss.shape == () and loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    for _, g in tree_flatten_with_path(grads):
        assert bool(torch.isfinite(g).all())
    assert_trees_close(grads, jgrads, RTOL, ATOL)


@pytest.mark.parametrize("name,nan_padding", CASES, ids=CASE_IDS)
def test_three_train_steps_match_reference(name, nan_padding):
    jcfg, tcfg, np_params, batches = _setup(name, nan_padding, steps=3)
    jopt, topt = _optimizers()
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = jopt.init(jp)
    jstep = jax.jit(JR.make_train_step(jcfg, jopt, None))
    tp = R.params_from_numpy(np_params, "cpu")
    ts = topt.init(tp)
    tstep = R.make_train_step(tcfg, topt)
    for b in batches:
        jp, js, jm = jstep(jp, js, _jax_batch(b))
        tp, ts, tm = tstep(tp, ts, _torch_batch(b))
        assert tm["loss"].shape == () and not tm["loss"].requires_grad
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    assert_trees_close(tp, jp, STEP_RTOL, ATOL)
    assert_trees_close(ts, js, STEP_RTOL, ATOL)
    assert not any(t.requires_grad for _, t in tree_flatten_with_path((tp, ts)))


@pytest.fixture
def cuda_route(monkeypatch):
    """The card's autograd path on the CPU: ``ops`` takes every tensor for a
    CUDA one, and the kernels are their plain versions, counted."""
    calls = {"K1": 0, "K1'": 0, "K2": 0, "K2'": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    monkeypatch.setattr(K1, "embedding_bag", counted("K1", ref.embedding_bag_ref))
    monkeypatch.setattr(K1, "embedding_bag_backward",
                        counted("K1'", ref.embedding_bag_backward_ref))
    monkeypatch.setattr(K2, "dot_interaction", counted("K2", ref.dot_interaction_ref))
    monkeypatch.setattr(K2, "dot_interaction_backward",
                        counted("K2'", ref.dot_interaction_backward_ref))
    return calls


@pytest.mark.parametrize("name,nan_padding", CASES, ids=CASE_IDS)
def test_card_autograd_wiring(name, nan_padding, cuda_route):
    """Through the autograd Functions (K1 masked + K1', K2 + K2'), the loss
    and every gradient leaf equal the reference's: no leaf is missing, and
    the table's gradient comes from K1' alone."""
    jcfg, tcfg, np_params, (b,) = _setup(name, nan_padding)
    jloss, jgrads = _jax_loss_and_grads(jcfg, np_params, b)
    loss, grads = R.loss_and_grads(tcfg, R.params_from_numpy(np_params, "cpu"),
                                   _torch_batch(b))
    groups = 2 if SPECS[name][1] else 1
    assert cuda_route == {"K1": groups, "K1'": groups, "K2": 1, "K2'": 1}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    assert_trees_close(grads, jgrads, RTOL, ATOL)
    with torch.no_grad():  # no gradient wanted: the plain launches, no Function
        R.forward(tcfg, R.params_from_numpy(np_params, "cpu"), _torch_batch(b))
    assert cuda_route == {"K1": 2 * groups, "K1'": groups, "K2": 2, "K2'": 1}


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "weighted"])
@pytest.mark.parametrize("nnz,D", [(1, 16), (3, 17), (4, 64)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_embedding_bag_backward_ref_matches_autograd(masked, nnz, D, dtype):
    """K1''s plain version against autograd of K1's plain version: ids
    outside [0, V), repeated rows, fractional and zero weights, and NaN in
    the gradient of every bag whose slots all weigh 0 (masked: no row sees
    it; weighted: 0 x NaN reaches the rows, as autograd has it)."""
    rng = np.random.default_rng(nnz * D)
    V, bags = 50, 37
    table = torch.from_numpy(rng.normal(size=(V, D))).to(dtype).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(-5, V + 5, bags * nnz).astype(np.int32))
    w = torch.from_numpy((rng.random(bags * nnz) + 0.5).astype(np.float32))
    w[torch.from_numpy(rng.random(bags * nnz) < 0.4)] = 0.0
    w[:nnz] = 0.0  # bag 0 is all padding
    g = torch.from_numpy(rng.normal(size=(bags, D))).to(dtype)
    g[(w.reshape(bags, nnz) == 0).all(dim=1)] = float("nan")
    (want,) = torch.autograd.grad(ref.embedding_bag_ref(table, idx, w, bags, masked=masked),
                                  table, g)
    got = ref.embedding_bag_backward_ref(g, idx, w, V, masked=masked)
    assert got.dtype == dtype and got.shape == (V, D)
    assert bool(torch.isfinite(got).all()) == masked
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def test_embedding_bag_backward_ref_matches_jax_vjp():
    """K1''s plain version (weighted, ids in range) against XLA's autodiff
    of the reference's plain K1."""
    rng = np.random.default_rng(3)
    V, D, bags, nnz = 40, 8, 21, 4
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, bags * nnz).astype(np.int32)
    w = (rng.random(bags * nnz) * (rng.random(bags * nnz) < 0.7)).astype(np.float32)
    g = rng.normal(size=(bags, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jref.embedding_bag_ref(t, jnp.asarray(idx), jnp.asarray(w), bags),
                     jnp.asarray(table))
    got = ref.embedding_bag_backward_ref(torch.from_numpy(g), torch.from_numpy(idx),
                                         torch.from_numpy(w), V)
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,F,D", [(3, 5, 8), (4, 27, 16), (2, 17, 64)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_dot_interaction_backward_ref_matches_autograd(B, F, D, dtype):
    rng = np.random.default_rng(B * F)
    x = torch.from_numpy(rng.normal(size=(B, F, D))).to(dtype).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(B, F * (F + 1) // 2))).to(dtype)
    iu, ju = torch.triu_indices(F, F)
    (want,) = torch.autograd.grad(ref.dot_interaction_ref(x)[:, iu, ju], x, g)
    got = ref.dot_interaction_backward_ref(x.detach(), g)
    assert got.dtype == dtype and got.shape == (B, F, D)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def test_dot_interaction_backward_ref_matches_jax_vjp():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 27, 16)).astype(np.float32)
    g = rng.normal(size=(6, 27 * 28 // 2)).astype(np.float32)
    _, vjp = jax.vjp(jops.dot_interaction_triu, jnp.asarray(x))
    got = ref.dot_interaction_backward_ref(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=RTOL, atol=1e-5)


# ------------------------------------------------------------------ refusals


def test_backward_kernels_refuse_cpu_tensors():
    before = (K1.launches_backward, K2.launches_backward)
    with pytest.raises(ValueError, match="CUDA"):
        K1.embedding_bag_backward(torch.zeros(2, 8), torch.zeros(4, dtype=torch.int32),
                                  torch.ones(4), 10)
    with pytest.raises(ValueError, match="CUDA"):
        K2.dot_interaction_backward(torch.zeros(2, 3, 8), torch.zeros(2, 6))
    assert (K1.launches_backward, K2.launches_backward) == before


def test_no_gradient_for_weights_or_bf16():
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bag(torch.zeros(5, 8), idx, torch.ones(4, requires_grad=True), 2)
    with pytest.raises(TypeError, match="only f32 tables train"):
        ops.embedding_bag(torch.zeros(5, 8, dtype=torch.bfloat16, requires_grad=True),
                          idx, torch.ones(4), 2)
    with pytest.raises(TypeError, match="f32 only"):
        ops.dot_interaction_triu(torch.zeros(2, 3, 8, dtype=torch.bfloat16,
                                             requires_grad=True))
    with torch.no_grad():  # no gradient wanted: bf16 serves as before
        ops.embedding_bag(torch.zeros(5, 8, dtype=torch.bfloat16, requires_grad=True),
                          idx, torch.ones(4), 2)


def test_mesh_and_lm_refused():
    """The mesh step is ported (tests/test_torch_sharded.py holds it against
    the reference's), and so is the LM trainer, refused no more: ``--model
    lm`` trains lm-small (tests/test_torch_lm_train.py holds it against the
    reference's)."""
    _, tcfg = _cfgs("tiny")
    assert callable(R.make_train_step(tcfg, O.make_sgd(0.1), mesh=object()))
    args = ttrain.parse_args(["--model", "lm", "--device", "cpu", "--steps", "2",
                              "--batch", "2", "--seq", "8"])
    out = ttrain.train_lm(args)
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))


def test_train_defaults_to_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    args = ttrain.parse_args(["--steps", "2"])
    assert (args.device, args.steps, args.batch, args.model) == ("cuda", 2, 256, "dlrm")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ttrain.train_recsys(args)


# --------------------------------------------------- the trainer end to end


def _link_copy(src, dst):
    shutil.copytree(src, dst, copy_function=os.link)


def test_train_recsys_resumes_the_references_checkpoint(tmp_path):
    """The reference's ``train_recsys --steps 2 --batch 16`` writes a
    checkpoint of dlrm-100m; both packages resume from copies of it to step
    4 (the same batches: ``default_rng(seed * 100_003 + step)``), and their
    last losses agree; the port's run then resumes in the reference too."""
    ck = tmp_path / "ck"
    common = dict(batch=16, seed=0, ckpt_every=50, reshard_at=0, log_every=10)
    jtrain.train_recsys(argparse.Namespace(steps=2, ckpt_dir=str(ck), resume=False, **common))
    _link_copy(ck, tmp_path / "jax")
    _link_copy(ck, tmp_path / "port")
    jout = jtrain.train_recsys(argparse.Namespace(steps=4, ckpt_dir=str(tmp_path / "jax"),
                                                  resume=True, **common))
    tout = ttrain.train_recsys(ttrain.parse_args(
        ["--device", "cpu", "--steps", "4", "--batch", "16", "--resume", "--reshard-at", "3",
         "--ckpt-dir", str(tmp_path / "port")]))
    assert tout["steps"] == 2 and tout["device"] == "cpu"
    np.testing.assert_allclose(tout["first_loss"], jout["first_loss"], rtol=RTOL)
    np.testing.assert_allclose(tout["final_loss"], jout["final_loss"], rtol=RTOL)
    assert CheckpointManager(tmp_path / "port").latest_step() == 3
    # ... and the port's step-3 checkpoint resumes in the reference
    jnext = jtrain.train_recsys(argparse.Namespace(steps=5, ckpt_dir=str(tmp_path / "port"),
                                                   resume=True, **common))
    jref_next = jtrain.train_recsys(argparse.Namespace(steps=5, ckpt_dir=str(tmp_path / "jax"),
                                                       resume=True, **common))
    np.testing.assert_allclose(jnext["final_loss"], jref_next["final_loss"], rtol=RTOL)


@pytest.mark.parametrize("mod,symbols", [
    (K1, (K1.BWD_SYMBOL, K1.BWD_OCC_SYMBOL)), (K2, (K2.BWD_SYMBOL,))],
    ids=["embedding_bag_backward", "dot_interaction_backward"])
def test_backward_symbols_exist_in_source(mod, symbols):
    """K1' and K2' are exported by their forward's .cu source, and the
    wrapper binds them with the forward's library."""
    import re

    from repro_torch.kernels import build
    src = (build.CSRC / f"{mod.NAME}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(symbols) <= exported
    assert set(symbols) <= set(mod._SIGNATURES)
