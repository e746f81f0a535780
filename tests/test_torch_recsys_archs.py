"""repro_torch's recsys archs, their retrieval and the config registry
against the JAX package, on the CPU.

Every arch of ``repro.models.recsys`` (wide_deep with a separate wide table,
with ``fuse_wide`` and without wide; autoint, two_tower, dcn, deepfm, mind,
dlrm) at tiny sizes, as tests/test_system.py builds them.  Weights come from
the reference's ``jax.random`` init and cross over with
``params_from_numpy``; batches are seeded numpy.  The reference's gradients
come from its own ``make_train_step`` with an optimizer that hands the
gradients back as the new params, so its three losses are its own.
Tolerances (f32 on both sides, summation orders differ):
  * forward scores, loss and every gradient leaf: rtol 1e-5, atol 1e-6
    (a gradient leaf whose largest magnitude m passes 1: atol 1e-6 m; two
    tower's temperature of 0.05 makes its gradients ~100);
  * params and optimizer state after three steps: rtol 1e-4, atol 1e-6;
  * retrieval values rtol 1e-5, atol 1e-6 and indices equal (the scores are
    tie-free: ``jax.lax.top_k`` and ``torch.topk`` order ties differently).
The registry's cells are compared with the reference's ``build_cell`` on an
abstract 16x16 (and 2x16x16) mesh: shapes, dtypes and PartitionSpecs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import abstract_mesh
from repro.configs import recsys_common as jrc
from repro.core.sharding import TableSpec as JaxTableSpec
from repro.models import recsys as JR
from repro.optim import optimizers as JO
from repro_torch import configs
from repro_torch.configs import recsys_common as RC
from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.launch.mesh import PRODUCTION_SHAPES, AbstractMesh
from repro_torch.models import recsys as R
from repro_torch.optim import optimizers as O
from repro_torch.utils import keystr, tree_flatten_with_path

RTOL, ATOL = 1e-5, 1e-6
STEP_TOL = (1e-4, 1e-6)
B = 16
SPECS = [("a", 300, 4, "sum"), ("b", 200, 1, "sum"), ("c", 64, 2, "mean"), ("d", 50, 1, "sum")]
MIND_SPECS = [("item", 500, 1, "sum")]

# name -> (RecsysConfig keywords, tables)
ARCH_CASES = {
    "dlrm": (dict(arch="dlrm", n_dense=5, bottom_mlp=(16, 8), mlp=(16, 8)), SPECS),
    "wide_deep": (dict(arch="wide_deep", n_dense=5, mlp=(16, 8), use_wide=True), SPECS),
    "wide_deep_fused": (dict(arch="wide_deep", n_dense=5, mlp=(16, 8), use_wide=True,
                             fuse_wide=True), SPECS),
    "wide_deep_no_wide": (dict(arch="wide_deep", mlp=(16, 8)), SPECS),
    "autoint": (dict(arch="autoint", attn_layers=2, attn_heads=2, d_attn=8), SPECS),
    "two_tower": (dict(arch="two_tower", user_tables=2, mlp=(16, 8)), SPECS),
    "dcn": (dict(arch="dcn", n_dense=5, mlp=(16, 8), n_cross=2, cross_rank=4), SPECS),
    "deepfm": (dict(arch="deepfm", n_dense=5, mlp=(16, 8)), SPECS),
    "mind": (dict(arch="mind", n_interests=3, capsule_iters=3, hist_len=10), MIND_SPECS),
}
RECSYS_IDS = ["autoint", "dcn-v2", "deepfm", "dlrm-flexemr", "mind", "two-tower-retrieval",
              "wide-deep"]


def _cfgs(name, **over):
    kw, specs = ARCH_CASES[name]
    kw = dict(name=name, embed_dim=8, **{**kw, **over})
    jcfg = JR.RecsysConfig(
        tables=tuple(JaxTableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in specs), **kw)
    tcfg = R.RecsysConfig(
        tables=tuple(TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in specs), **kw)
    return jcfg, tcfg


def _np_params(jcfg, seed=0):
    """The reference's init; mind's item table scaled from N(0, 0.01^2) to
    N(0, 1): at 0.01 its scores are ~1e-8 and its gradients rounding noise,
    which three Adam steps turn into steps of +-lr."""
    params = jax.tree_util.tree_map(np.asarray, JR.init_params(jcfg, jax.random.key(seed)))
    if jcfg.arch == "mind":
        params["emb"]["table"] = params["emb"]["table"] * np.float32(100.0)
    return params


def _batch(tcfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    if tcfg.arch == "mind":
        return syn.mind_batch(rng, tcfg.tables[0].vocab, b, tcfg.hist_len)
    return syn.recsys_batch(rng, tcfg.tables, b, n_dense=tcfg.n_dense)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree):
    return {keystr(p): x for p, x in tree_flatten_with_path(tree)}


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def _close(got, want, tol=(RTOL, ATOL)):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol[0], atol=tol[1])


def _trees_close(got, want, tol=(RTOL, ATOL), scaled=False):
    """Leaf by leaf; with ``scaled`` a leaf's atol is times its largest
    magnitude where that passes 1 (a gradient of ~100 sums terms of that
    size, so an element near 0 carries their rounding)."""
    got, want = _flat(got), _jflat(want)
    assert list(got) == list(want)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        scale = max(1.0, float(np.abs(want[key]).max(initial=0.0))) if scaled else 1.0
        _close(got[key].detach().numpy(), want[key], (tol[0], tol[1] * scale))


_GRADS = JO.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))


# ------------------------------------------------------------ per arch


@pytest.mark.parametrize("name", list(ARCH_CASES))
def test_params_match_reference_shapes(name):
    jcfg, tcfg = _cfgs(name)
    want = _jflat(_np_params(jcfg))
    got = _flat(R.init_params(tcfg, device="cpu"))
    assert list(got) == list(want)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape and got[key].dtype == torch.float32


@pytest.mark.parametrize("name", list(ARCH_CASES))
def test_forward_matches_reference(name):
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg)
    b = _batch(tcfg)
    want = jax.jit(lambda p, bb: JR.forward(jcfg, p, bb, None))(
        jax.tree_util.tree_map(jnp.asarray, np_params), _jax(b))
    with torch.no_grad():
        got = R.forward(tcfg, R.params_from_numpy(np_params, "cpu"), _torch(b))
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", list(ARCH_CASES))
def test_loss_and_grads_match_reference(name):
    """The arch's loss (BCE; two_tower's in-batch softmax over the lookup;
    mind's BPR) and every gradient leaf against the reference's."""
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg)
    b = _batch(tcfg)
    jgrads, _, m = jax.jit(JR.make_train_step(jcfg, _GRADS, None))(
        jax.tree_util.tree_map(jnp.asarray, np_params), (), _jax(b))
    loss, grads = R.loss_and_grads(tcfg, R.params_from_numpy(np_params, "cpu"), _torch(b))
    assert loss.shape == () and loss.dtype == torch.float32
    _close(loss.numpy(), m["loss"])
    _trees_close(grads, jgrads, scaled=True)


@pytest.mark.parametrize("name", list(ARCH_CASES))
def test_three_train_steps_match_reference(name):
    """Three steps of ``make_train_step`` with the registry's optimizer mix
    (rowwise AdaGrad on ``emb`` and ``wide``, Adam elsewhere) on three
    batches: losses, params and optimizer state."""
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg)
    jopt, topt = jrc.make_recsys_optimizer(), RC.make_recsys_optimizer()
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = jopt.init(jp)
    tp = R.params_from_numpy(np_params, "cpu")
    ts = topt.init(tp)
    jstep = jax.jit(JR.make_train_step(jcfg, jopt, None))
    tstep = R.make_train_step(tcfg, topt, None)
    for s in range(3):
        b = _batch(tcfg, seed=s)
        jp, js, jm = jstep(jp, js, _jax(b))
        tp, ts, tm = tstep(tp, ts, _torch(b))
        _close(tm["loss"].numpy(), jm["loss"], STEP_TOL)
    _trees_close(tp, jp, STEP_TOL)
    _trees_close(ts, js, STEP_TOL)


@pytest.mark.parametrize("rows", [R.LSE_ROWS, 5], ids=["one_block", "blocks_of_5"])
@pytest.mark.parametrize("with_log_q", [False, True], ids=["plain", "log_q"])
def test_in_batch_softmax_loss_matches_reference(with_log_q, rows, monkeypatch):
    """The loss and its gradients (pooled rows and params), the logsumexp in
    one block of rows and in blocks of 5 (the last one short)."""
    monkeypatch.setattr(R, "LSE_ROWS", rows)
    jcfg, tcfg = _cfgs("two_tower")
    np_params = _np_params(jcfg)
    rng = np.random.default_rng(3)
    pooled = rng.standard_normal((B, len(SPECS), 8)).astype(np.float32)
    log_q = np.log(rng.uniform(0.01, 1.0, B)).astype(np.float32) if with_log_q else None

    def jloss(p, x):
        return JR.in_batch_softmax_loss(jcfg, p, x, None if log_q is None else jnp.asarray(log_q))

    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    want, (jg, jx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(pooled))
    tp = R.params_from_numpy(np_params, "cpu")
    x = torch.from_numpy(pooled).requires_grad_(True)
    leaves = [leaf.requires_grad_(True) for leaf in _flat(tp).values()]
    got = R.in_batch_softmax_loss(tcfg, tp, x,
                                  None if log_q is None else torch.from_numpy(log_q))
    _close(got.detach().numpy(), want)
    grads = torch.autograd.grad(got, [x] + leaves, allow_unused=True)
    _close(grads[0].numpy(), jx)
    want_g = _jflat(jg)
    for (key, _), g in zip(_flat(tp).items(), grads[1:]):
        if key.startswith("['emb']"):  # the loss takes pooled rows, not the table
            assert g is None and not want_g[key].any()
            continue
        _close(g.numpy(), want_g[key])


def test_fused_wide_equals_separate_wide():
    """The port's wide_deep with ``fuse_wide`` (8 extra table columns, one
    lookup) equals the separate wide table on the same values: the
    reference's test_sharded_paths design, scores and loss."""
    _, sep = _cfgs("wide_deep")
    _, fused = _cfgs("wide_deep_fused")
    pa = R.init_params(sep, seed=1, device="cpu")
    table = torch.cat([pa["emb"]["table"], pa["wide"]["table"]], dim=1)
    pb = {**{k: v for k, v in pa.items() if k != "wide"}, "emb": {"table": table}}
    assert R.init_params(fused, device="cpu")["emb"]["table"].shape == table.shape
    b = _torch(_batch(sep, seed=4))
    with torch.no_grad():
        _close(R.forward(fused, pb, b).numpy(), R.forward(sep, pa, b).numpy())
    la, ga = R.loss_and_grads(sep, pa, b)
    lb, gb = R.loss_and_grads(fused, pb, b)
    _close(lb.numpy(), la.numpy())
    _close(gb["emb"]["table"].numpy(),
           torch.cat([ga["emb"]["table"], ga["wide"]["table"]], dim=1).numpy())


def test_server_dense_stage_stays_dlrm_only():
    """``dense_forward`` (the serving tier's ranker stage) runs dlrm only,
    as the reference server's ``_dense_fn`` does; the other archs serve
    through ``forward``."""
    _, tcfg = _cfgs("deepfm")
    params = R.init_params(tcfg, device="cpu")
    pooled = torch.zeros((2, len(SPECS), 8))
    with pytest.raises(NotImplementedError, match="dlrm"):
        R.dense_forward(tcfg, params, pooled, torch.zeros((2, 5)))


def test_two_tower_descends():
    """test_system's two-tower check on the port: 10 Adam steps on one batch
    lower the in-batch softmax loss."""
    tables = (TableSpec("u", 2000, nnz=1), TableSpec("ug", 50, nnz=1),
              TableSpec("i", 3000, nnz=1), TableSpec("ic", 20, nnz=1))
    cfg = R.RecsysConfig(name="tt", arch="two_tower", tables=tables, embed_dim=16,
                         user_tables=2, mlp=(64, 32))
    opt = O.make_adam(1e-3)
    params = R.init_params(cfg, seed=1, device="cpu")
    state = opt.init(params)
    step = R.make_train_step(cfg, opt, None)
    batch = _torch(syn.recsys_batch(np.random.default_rng(0), tables, 32))
    losses = []
    for _ in range(10):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


# ----------------------------------------------------------- retrieval


def test_retrieval_topk_matches_reference():
    jcfg, tcfg = _cfgs("two_tower")
    np_params = _np_params(jcfg)
    b = _batch(tcfg, b=4)
    cands = np.random.default_rng(5).standard_normal((300, 8)).astype(np.float32)
    jv, ji = JR.retrieval_topk(jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), _jax(b),
                               jnp.asarray(cands), k=10)
    tv, ti = R.retrieval_topk(tcfg, R.params_from_numpy(np_params, "cpu"), _torch(b),
                              torch.from_numpy(cands), k=10)
    assert tv.shape == (4, 10) and ti.shape == (4, 10)
    _close(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_mind_retrieval_matches_reference():
    jcfg, tcfg = _cfgs("mind")
    np_params = _np_params(jcfg)
    b = _batch(tcfg, b=1)
    b = {"hist": b["hist"], "hist_mask": b["hist_mask"],
         "cand_ids": np.random.default_rng(6).permutation(500)[:200].astype(np.int32)}
    jv, ji = JR.mind_retrieval(jcfg, jax.tree_util.tree_map(jnp.asarray, np_params), _jax(b),
                               k=10)
    tv, ti = R.mind_retrieval(tcfg, R.params_from_numpy(np_params, "cpu"), _torch(b), k=10)
    assert tv.shape == (1, 10)
    _close(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------------------ registry


def test_registry_lists_the_seven_recsys_archs():
    """The seven recsys ids beside the five LM ids (the LM registry:
    tests/test_torch_lm_train.py) and the GNN id, registered as the
    reference registers it (tests/test_torch_gnn.py): the port's registry
    holds every id of the reference's."""
    lm_ids = ["arctic-480b", "llama3-405b", "olmoe-1b-7b", "qwen2-72b", "stablelm-3b"]
    assert configs.list_archs() == sorted(RECSYS_IDS + lm_ids + ["graphsage-reddit"])
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    for arch_id in RECSYS_IDS:
        arch = configs.get(arch_id)
        assert (arch.id, arch.kind, arch.shapes) == (arch_id, "recsys", tuple(RC.RECSYS_SHAPES))
        assert arch.notes == jconfigs.get(arch_id).notes
    gnn, jgnn = configs.get("graphsage-reddit"), jconfigs.get("graphsage-reddit")
    assert (gnn.kind, gnn.shapes, gnn.notes) == (jgnn.kind, jgnn.shapes, jgnn.notes)
    assert gnn.kind == "gnn" and not hasattr(configs, "NOT_PORTED")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("nope")


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_published_configs_match_reference(arch_id):
    mod = arch_id.replace("-", "_")
    jcfg = getattr(jconfigs, mod).make_config()
    tcfg = getattr(configs, mod).make_config()
    assert [(s.name, s.vocab, s.nnz, s.pooling) for s in jcfg.tables] == \
        [(s.name, s.vocab, s.nnz, s.pooling) for s in tcfg.tables]
    for f in dataclasses.fields(jcfg):
        if f.name not in ("tables", "param_dtype", "compute_dtype", "comm_dtype"):
            assert getattr(jcfg, f.name) == getattr(tcfg, f.name), f.name
    assert (tcfg.param_dtype, tcfg.compute_dtype, tcfg.comm_dtype) == (
        torch.float32, torch.float32, None)


def _spec_axes(spec, ndim):
    """Per dimension, the mesh axes a spec splits it over (jax or port)."""
    out = []
    for d in range(ndim):
        el = spec[d] if d < len(spec) else None
        out.append(() if el is None else (el,) if isinstance(el, str) else tuple(el))
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi_pod"])
@pytest.mark.parametrize("shape", list(RC.RECSYS_SHAPES))
@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_build_cell_matches_reference_input_specs(arch_id, shape, multi_pod):
    """The cell's arguments (meta tensors: no allocation) and in_shardings
    against the reference's ``input_specs`` / ``build_cell`` on the
    production mesh."""
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
    if not multi_pod and shape == "serve_p99":
        assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(
            jconfigs.input_specs(arch_id, shape))] == [
            tuple(t.shape) for _, t in tree_flatten_with_path(configs.input_specs(arch_id,
                                                                                  shape))]


@pytest.mark.parametrize("arch_id", RECSYS_IDS)
def test_smoke_on_the_cpu(arch_id):
    out = configs.get(arch_id).smoke("cpu")
    assert np.isfinite(out["loss"]) and out["scores_shape"] == (8,)
