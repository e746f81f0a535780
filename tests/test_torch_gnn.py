"""repro_torch's GNN slice against the JAX package, on the CPU.

``data.graph_sampler`` bit for bit with the same seeded generator;
``models.gnn``'s aggregation in the reference's index semantics (masked
edges, sources out of range and negative, destinations out of range), its
layer, its three forwards, the node loss and the train steps with the
reference's ``jax.random`` weights carried across (``params_from_numpy``);
the reference's dense-adjacency property as a hypothesis test of the port;
``configs.graphsage_reddit``'s cells against the reference's on the two
production meshes, its smoke, and its refusal of a card that is not there.
The mesh paths run in ``tests/test_torch_sharded.py``'s one spawn.

Tolerances (f32 on both sides, summation orders differ): forwards, losses
and the aggregation at rtol 1e-5, atol 1e-6; gradients at atol 1e-6 times
the leaf's largest magnitude where that passes 1; params and Adam state
after three steps at rtol 1e-4, atol 1e-6 (Adam's first steps divide by
the gradient's own size).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.compat import abstract_mesh
from repro.configs import graphsage_reddit as JGR
from repro.data import graph_sampler as JGS
from repro.data import synthetic as jsyn
from repro.models import gnn as JG
from repro.optim import optimizers as JO
from repro_torch import configs
from repro_torch.configs import graphsage_reddit as GR
from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.data import graph_sampler as GS
from repro_torch.data import synthetic as syn
from repro_torch.launch.mesh import PRODUCTION_SHAPES, AbstractMesh
from repro_torch.models import gnn as G
from repro_torch.optim import optimizers as O
from repro_torch.utils import keystr, tree_flatten_with_path

RTOL, ATOL = 1e-5, 1e-6
STEP_TOL = (1e-4, 1e-6)
N, E, D_IN = 48, 200, 12
CFG = dict(name="t", n_layers=2, d_in=D_IN, d_hidden=8, n_classes=5)


def _cfgs(**over):
    kw = {**CFG, **over}
    return JG.GNNConfig(**kw), G.GNNConfig(**kw)


def _np_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, JG.init_params(jcfg, jax.random.key(seed)))


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree):
    return {keystr(p): x for p, x in tree_flatten_with_path(tree)}


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def _close(got, want, tol=(RTOL, ATOL)):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol[0], atol=tol[1])


def _trees_close(got, want, tol=(RTOL, ATOL), scaled=False):
    got, want = _flat(got), _jflat(want)
    assert list(got) == list(want)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        scale = max(1.0, float(np.abs(want[key]).max(initial=0.0))) if scaled else 1.0
        _close(got[key].detach().numpy(), want[key], (tol[0], tol[1] * scale))


def _graph(seed=0, n=N, e=E, d=D_IN, classes=5, power_law=True):
    return jsyn.random_graph(np.random.default_rng(seed), n, e, d, classes,
                             power_law=power_law)


_GRADS = JO.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
_TGRADS = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))


# ------------------------------------------------------------------ sampler


def test_edges_to_csr_matches_reference():
    g = _graph()
    want = JGS.edges_to_csr(g["edges"], N, g["feats"], g["labels"])
    got = GS.edges_to_csr(g["edges"], N, g["feats"], g["labels"])
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.n_nodes == want.n_nodes == N


@pytest.mark.parametrize("seed,fanouts", [(0, (3, 2)), (1, (15, 10)), (2, (4,)),
                                          (3, (2, 2, 2))])
def test_sample_block_is_bit_equal(seed, fanouts):
    """Same generator, same blocks: node ids, features, hop edges and masks
    (deepest hop first), labels; the targets include a node of degree 0,
    whose slots stay node 0 and masked."""
    g = _graph(seed)
    csr_j = JGS.edges_to_csr(g["edges"], N, g["feats"], g["labels"])
    csr_t = GS.edges_to_csr(g["edges"], N, g["feats"], g["labels"])
    deg = np.diff(csr_t.indptr)
    targets = np.concatenate([[int(np.flatnonzero(deg == 0)[0])],
                              np.random.default_rng(seed).choice(N, 5, replace=False)])
    want = JGS.sample_block(csr_j, np.random.default_rng(seed + 7), targets, fanouts)
    got = GS.sample_block(csr_t, np.random.default_rng(seed + 7), targets, fanouts)
    for f in ("node_ids", "feats", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.n_targets == want.n_targets == len(targets)
    assert len(got.hop_edges) == len(want.hop_edges) == len(fanouts)
    for a, b in zip(got.hop_edges + got.hop_masks, want.hop_edges + want.hop_masks):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the degree-0 target's slots of the first hop: masked, node 0
    first = got.hop_masks[-1].reshape(len(targets), fanouts[0])
    assert not first[0].any() and first[1:].sum() > 0
    assert np.all(got.node_ids[len(targets):len(targets) + fanouts[0]] == 0)


@pytest.mark.parametrize("batch,fanouts", [(4, (15, 10)), (1024, (15, 10)), (7, (25, 10)),
                                           (3, (2, 3, 4))])
def test_block_sizes_match_reference(batch, fanouts):
    assert GS.block_sizes(batch, fanouts, 602) == JGS.block_sizes(batch, fanouts, 602)
    g = _graph()
    blk = GS.sample_block(GS.edges_to_csr(g["edges"], N, g["feats"], g["labels"]),
                          np.random.default_rng(0), np.arange(min(batch, 4)), fanouts)
    sizes = GS.block_sizes(min(batch, 4), fanouts, D_IN)
    assert blk.feats.shape == (sizes["n_sub"], D_IN)
    assert [len(e) for e in blk.hop_edges] == sizes["hop_edges"]


# -------------------------------------------------------------- aggregation


def _agg_case(name):
    """(h, src, dst, mask) of one edge case, n = 6 rows."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((6, 4)).astype(np.float32)
    src = rng.integers(0, 6, 12).astype(np.int32)
    dst = rng.integers(0, 6, 12).astype(np.int32)
    mask = np.ones(12, bool)
    if name == "masked":
        mask[[1, 4, 7]] = False
    elif name == "src_past_end":  # gathers NaN, which a zero weight keeps
        src[[0, 5]] = [6, 1000]
        mask[5] = False
    elif name == "src_negative":  # in range: wraps; past -n: NaN
        src[[2, 3, 8]] = [-1, -6, -7]
    elif name == "dst_out_of_range":  # dropped, and so is the count
        dst[[1, 6, 9]] = [6, -1, 99]
    elif name == "dropped_nan":  # a NaN message to a dropped row leaves no trace
        src[4], dst[4] = 50, -3
    return h, src, dst, mask


AGG_CASES = ["plain", "masked", "src_past_end", "src_negative", "dst_out_of_range",
             "dropped_nan"]


@pytest.mark.parametrize("name", AGG_CASES)
def test_aggregate_matches_reference_semantics(name):
    """Sums and counts (NaN where the reference's ``jnp.take`` fills it), and
    the gradient of the finite sums against ``jax.grad``."""
    h, src, dst, mask = _agg_case(name)
    js, jc = JG._aggregate_dense(jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(mask), 6)
    th = torch.from_numpy(h).requires_grad_(True)
    ts, tc = G._aggregate_dense(th, torch.from_numpy(src), torch.from_numpy(dst),
                                torch.from_numpy(mask), 6)
    assert np.array_equal(np.isnan(ts.detach().numpy()), np.isnan(np.asarray(js)))
    if name in ("src_past_end", "src_negative"):
        assert np.isnan(np.asarray(js)).any()
    _close(ts.detach().numpy(), js)
    _close(tc.numpy(), jc)
    w = np.random.default_rng(4).standard_normal((6, 4)).astype(np.float32)

    def jloss(x):
        s, _ = JG._aggregate_dense(x, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), 6)
        return jnp.sum(jnp.where(jnp.isnan(s), 0.0, s * w))

    (tg,) = torch.autograd.grad(torch.where(torch.isnan(ts), 0.0, ts * torch.from_numpy(w)).sum(),
                                th)
    _close(tg.numpy(), jax.grad(jloss)(jnp.asarray(h)))


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_aggregation_in_chunks_matches_whole(monkeypatch, chunk):
    """``EDGE_CHUNK`` edges a message buffer: the forward and its gradient
    equal one whole pass's (the CPU's index_add_ adds in edge order)."""
    _, tcfg = _cfgs()
    params = G.init_params(tcfg, seed=1, device="cpu")
    g = _graph()
    g["edges"][3, 0] = -1  # a source that wraps
    g["edges"][5, 1] = -2  # a dropped destination
    args = [torch.from_numpy(g[k]) for k in ("feats", "edges", "edge_mask")]

    def loss(p, _):
        return G.forward_full_graph(tcfg, p, *args).square().sum()

    whole = G.loss_and_grads(loss, params, None)
    monkeypatch.setattr(G, "EDGE_CHUNK", chunk)
    chunked = G.loss_and_grads(loss, params, None)
    assert torch.equal(whole[0], chunked[0])
    for a, b in zip(_flat(whole[1]).values(), _flat(chunked[1]).values()):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_sage_layer_matches_reference():
    jcfg, _ = _cfgs()
    lp = _np_params(jcfg)["layers"][0]
    rng = np.random.default_rng(5)
    h = rng.standard_normal((N, D_IN)).astype(np.float32)
    neigh = rng.standard_normal((N, D_IN)).astype(np.float32)
    h[3] = neigh[3] = 0.0  # a row of zeros (the bias is 0): the norm's clip at 1e-6
    got = G.sage_layer(_torch(lp), torch.from_numpy(h), torch.from_numpy(neigh))
    want = JG.sage_layer(_jax(lp), jnp.asarray(h), jnp.asarray(neigh))
    _close(got.numpy(), want)
    assert np.all(got.numpy()[3] == 0)


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("power_law", [True, False])
def test_forward_full_graph_matches_reference(power_law):
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    g = _graph(power_law=power_law)
    g["edge_mask"][::7] = False
    want = JG.forward_full_graph(jcfg, _jax(np_params), *(_jax(g[k]) for k in
                                 ("feats", "edges", "edge_mask")))
    got = G.forward_full_graph(tcfg, G.params_from_numpy(np_params, "cpu"),
                               *(torch.from_numpy(g[k]) for k in ("feats", "edges", "edge_mask")))
    assert got.shape == (N, 5)
    _close(got.numpy(), want)


def _block(seed=0, targets=4, fanouts=(3, 2)):
    g = _graph(seed)
    csr = GS.edges_to_csr(g["edges"], N, g["feats"], g["labels"])
    return GS.sample_block(csr, np.random.default_rng(seed), np.arange(targets), fanouts)


def test_forward_minibatch_matches_reference():
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    blk = _block()
    want = JG.forward_minibatch(jcfg, _jax(np_params), jnp.asarray(blk.feats),
                                _jax(blk.hop_edges), _jax(blk.hop_masks), blk.n_targets)
    got = G.forward_minibatch(tcfg, G.params_from_numpy(np_params, "cpu"),
                              torch.from_numpy(blk.feats), _torch(blk.hop_edges),
                              _torch(blk.hop_masks), blk.n_targets)
    assert got.shape == (4, 5)
    _close(got.numpy(), want)


def _molecules(seed=0, g=6, n=7, e=10, d=D_IN, odd_ids=False):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((g, n, d)).astype(np.float32)
    edges = rng.integers(0, n, (g, e, 2)).astype(np.int32)
    mask = rng.random((g, e)) < 0.8
    if odd_ids:  # per graph: a wrapped source, a dropped destination
        edges[1, 0, 0], edges[2, 3, 1], edges[4, 2, 1] = -2, n, -1
    labels = rng.standard_normal(g).astype(np.float32)
    return {"feats": feats, "edges": edges, "edge_mask": mask, "labels": labels}


@pytest.mark.parametrize("odd_ids", [False, True])
def test_forward_molecule_matches_reference(odd_ids):
    """One batched pass with node offsets against the reference's vmap; ids
    keep their per-graph semantics (a wrapped source stays in its graph, a
    dropped destination does not reach the next graph)."""
    jcfg, tcfg = _cfgs(n_classes=1)
    np_params = _np_params(jcfg)
    b = _molecules(odd_ids=odd_ids)
    keys = ("feats", "edges", "edge_mask")
    want = JG.forward_molecule(jcfg, _jax(np_params), *(jnp.asarray(b[k]) for k in keys))
    got = G.forward_molecule(tcfg, G.params_from_numpy(np_params, "cpu"),
                             *(torch.from_numpy(b[k]) for k in keys))
    assert got.shape == (6, 1)
    _close(got.numpy(), want)


@given(n=st.integers(8, 40), e=st.integers(10, 120), seed=st.integers(0, 20))
@settings(max_examples=15, deadline=None)
def test_segment_aggregation_matches_dense_adjacency(n, e, seed):
    """The reference's property on the port: segment-sum message passing ==
    dense adjacency matmul."""
    rng = np.random.default_rng(seed)
    g = syn.random_graph(rng, n, e, 8, 3, power_law=False)
    cfg = G.GNNConfig(name="t", n_layers=1, d_in=8, d_hidden=4, n_classes=3)
    params = G.init_params(cfg, seed=seed, device="cpu")
    logits = G.forward_full_graph(cfg, params, torch.from_numpy(g["feats"]),
                                  torch.from_numpy(g["edges"]), torch.from_numpy(g["edge_mask"]))
    A = np.zeros((n, n), np.float32)
    for s, d in g["edges"]:
        A[d, s] += 1.0
    deg = np.maximum(A.sum(1, keepdims=True), 1.0)
    h = g["feats"]
    neigh = (A @ h) / deg
    lp = {k: v.numpy() for k, v in params["layers"][0].items()}
    out = np.maximum(h @ lp["w_self"] + neigh @ lp["w_neigh"] + lp["b"], 0.0)
    out = out / np.clip(np.linalg.norm(out, axis=-1, keepdims=True), 1e-6, None)
    want = out @ params["out"].numpy()
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_node_ce_loss_matches_reference(masked):
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((20, 7)) * 3).astype(np.float32)
    labels = rng.integers(0, 7, 20).astype(np.int32)
    mask = (rng.random(20) < 0.5).astype(np.float32) if masked else None
    want = JG.node_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = G.node_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    _close(got.numpy(), want)
    if masked:  # an empty mask: 0, not NaN
        zero = G.node_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                              torch.zeros(20))
        assert float(zero) == 0.0


# ----------------------------------------------------------------- training


def _steps(jstep, tstep, jp, tp, jopt, topt, jbatch, tbatch, steps=3):
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(steps):
        jp, js, jm = jstep(jp, js, jbatch)
        tp, ts, tm = tstep(tp, ts, tbatch)
        _close(tm["loss"].numpy(), jm["loss"])
    _trees_close(tp, jp, STEP_TOL)
    _trees_close(ts, js, STEP_TOL)


def _full_batch(masked_labels=False):
    g = _graph()
    g["edge_mask"][::5] = False
    if masked_labels:
        g["label_mask"] = np.random.default_rng(7).random(N) < 0.6
    return g


@pytest.mark.parametrize("masked_labels", [False, True])
def test_train_step_full_matches_reference(masked_labels):
    """The gradients (an optimizer that returns them), then 3 Adam steps."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg)
    b = _full_batch(masked_labels)
    jb, tb = _jax(b), _torch(b)
    jgrads, _, jm = jax.jit(JG.make_train_step_full(jcfg, _GRADS, None))(_jax(np_params), (), jb)
    tgrads, _, tm = G.make_train_step_full(tcfg, _TGRADS)(
        G.params_from_numpy(np_params, "cpu"), (), tb)
    _close(tm["loss"].numpy(), jm["loss"])
    _trees_close(tgrads, jgrads, scaled=True)
    jopt, topt = JO.make_adam(1e-3), O.make_adam(1e-3)
    _steps(jax.jit(JG.make_train_step_full(jcfg, jopt, None)),
           G.make_train_step_full(tcfg, topt), _jax(np_params),
           G.params_from_numpy(np_params, "cpu"), jopt, topt, jb, tb)


def _minibatch_cell_batch(cfg, blocks=2, tgt=4):
    """``blocks`` sampled blocks of ``tgt`` targets at fanout (15, 10), in
    the cell's layout (a leading dim of blocks)."""
    g = _graph(n=120, e=900, d=cfg.d_in, classes=cfg.n_classes)
    csr = GS.edges_to_csr(g["edges"], 120, g["feats"], g["labels"])
    rng = np.random.default_rng(8)
    blks = [GS.sample_block(csr, rng, rng.choice(120, tgt, replace=False), (15, 10))
            for _ in range(blocks)]
    return {"feats": np.stack([b.feats for b in blks]),
            "edges1": np.stack([b.hop_edges[0] for b in blks]),
            "mask1": np.stack([b.hop_masks[0] for b in blks]),
            "edges2": np.stack([b.hop_edges[1] for b in blks]),
            "mask2": np.stack([b.hop_masks[1] for b in blks]),
            "labels": np.stack([b.labels for b in blks])}


def test_minibatch_cell_step_matches_reference():
    """The minibatch_lg cell's step (its published widths, d 602 and 41
    classes; 2 blocks of 4 targets, the 16x16 mesh's block of the reference
    cell) with the gradients, then 3 Adam steps against the reference
    cell's jitted step."""
    jcell = JGR.build_cell("minibatch_lg", abstract_mesh((16, 16), ("data", "model")), False)
    tgt = JGR.SHAPES["minibatch_lg"]["batch_nodes"] // 256
    jcfg, tcfg = JGR._cfg(JGR.SHAPES["minibatch_lg"]), GR._cfg(GR.SHAPES["minibatch_lg"])
    np_params = _np_params(jcfg, seed=1)
    b = _minibatch_cell_batch(tcfg, tgt=tgt)
    jb, tb = _jax(b), _torch(b)
    jopt, topt = JO.make_adam(1e-3), O.make_adam(1e-3)
    tstep = G.make_train_step(GR.minibatch_loss(tcfg, tgt), topt)
    # the gradients: the reference cell's loss through jax.value_and_grad
    jgrads = jax.grad(lambda p: JG.node_ce_loss(
        jax.vmap(lambda f, e1, m1, e2, m2: JG.forward_minibatch(jcfg, p, f, [e1, e2], [m1, m2],
                                                                 tgt))(
            jb["feats"], jb["edges1"], jb["mask1"], jb["edges2"], jb["mask2"]).reshape(
            -1, jcfg.n_classes), jb["labels"].reshape(-1)))(_jax(np_params))
    _, tgrads = G.loss_and_grads(GR.minibatch_loss(tcfg, tgt), G.params_from_numpy(
        np_params, "cpu"), tb)
    _trees_close(tgrads, jgrads, scaled=True)
    _steps(jax.jit(jcell.step_fn), tstep, _jax(np_params), G.params_from_numpy(np_params, "cpu"),
           jopt, topt, jb, tb)


def test_molecule_cell_step_matches_reference():
    """The molecule cell's step at its published shape (128 graphs of 30
    nodes and 64 edges, d 32), gradients then 3 Adam steps, against the
    reference cell's jitted step (its mesh only lays the output out)."""
    jcfg, tcfg = JGR._cfg(JGR.SHAPES["molecule"]), GR._cfg(GR.SHAPES["molecule"])
    info = GR.SHAPES["molecule"]
    np_params = _np_params(jcfg, seed=2)
    b = _molecules(seed=9, g=info["batch"], n=info["n_nodes"], e=info["n_edges"],
                   d=info["d_feat"])
    jb, tb = _jax(b), _torch(b)
    jopt, topt = JO.make_adam(1e-3), O.make_adam(1e-3)
    tcell = GR.build_cell("molecule", None, False)
    jgrads = jax.grad(lambda p: jnp.mean((JG.forward_molecule(
        jcfg, p, jb["feats"], jb["edges"], jb["edge_mask"])[:, 0] - jb["labels"]) ** 2))(
        _jax(np_params))
    _, tgrads = G.loss_and_grads(GR.molecule_loss(tcfg), G.params_from_numpy(np_params, "cpu"),
                                 tb)
    _trees_close(tgrads, jgrads, scaled=True)
    jstep = jax.jit(JGR.build_cell("molecule", abstract_mesh((1, 1), ("data", "model")),
                                   False).step_fn)
    _steps(jstep, tcell.step_fn, _jax(np_params), G.params_from_numpy(np_params, "cpu"),
           jopt, topt, jb, tb)


# ------------------------------------------------------------------- params


def test_params_shapes_dtypes_and_scale():
    """The port's own init: the reference's tree, shapes and dtypes; weights
    uniform in +-1/sqrt(fan in), biases 0; the specs replicated."""
    jcfg, tcfg = _cfgs(d_in=200, d_hidden=64)
    want = _jflat(_np_params(jcfg))
    got = _flat(G.init_params(tcfg, seed=3, device="cpu"))
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32
        if k.endswith("['b']"):
            assert torch.all(got[k] == 0)
        else:
            bound = 1 / np.sqrt(got[k].shape[0])
            assert float(got[k].abs().max()) <= bound
            assert float(got[k].abs().max()) > 0.9 * bound
            assert abs(float(got[k].std()) - bound / np.sqrt(3)) < 0.1 * bound
    assert all(v.device.type == "meta" for v in _flat(G.abstract_params(tcfg)).values())
    specs = [s for _, s in tree_flatten_with_path(G.param_specs(tcfg),
                                                  lambda x: isinstance(x, P))]
    assert all(s.mesh_axes() == () for s in specs) and len(specs) == len(got)


def test_config_matches_reference():
    for shape in GR.SHAPES:
        jcfg, tcfg = JGR._cfg(JGR.SHAPES[shape]), GR._cfg(GR.SHAPES[shape])
        for f in dataclasses.fields(jcfg):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert (tcfg.param_dtype, tcfg.compute_dtype) == (torch.float32, torch.float32)
    assert GR.SHAPES == JGR.SHAPES


# ----------------------------------------------------------------- registry


def _spec_axes(spec, ndim):
    out = []
    for d in range(ndim):
        el = spec[d] if d < len(spec) else None
        out.append(() if el is None else (el,) if isinstance(el, str) else tuple(el))
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi_pod"])
@pytest.mark.parametrize("shape", list(GR.SHAPES))
def test_build_cell_matches_reference(shape, multi_pod):
    """The cell's arguments (meta tensors) and in_shardings against the
    reference's ``build_cell`` on the production mesh: E rounded up to 512,
    one sampled block a device, the molecule batch over the batch axes."""
    want = jconfigs.get("graphsage-reddit").build_cell(
        shape, abstract_mesh(*PRODUCTION_SHAPES[multi_pod]), multi_pod)
    got = configs.get("graphsage-reddit").build_cell(
        shape, AbstractMesh(*PRODUCTION_SHAPES[multi_pod]), multi_pod)
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


def test_one_device_cells():
    """``mesh=None`` builds the one-device cells: the minibatch cell takes
    one block of all 1,024 targets (169,984 nodes), nothing is split."""
    cell = GR.build_cell("minibatch_lg", None, False)
    batch = cell.args[2]
    assert tuple(batch["feats"].shape) == (1, 169984, 602)
    assert tuple(batch["edges1"].shape) == (1, 153600, 2)
    assert tuple(batch["edges2"].shape) == (1, 15360, 2)
    assert tuple(batch["labels"].shape) == (1, 1024)
    specs = [s for _, s in tree_flatten_with_path(cell.in_shardings, lambda x: isinstance(x, P))]
    assert all(s.mesh_axes() == () for s in specs)
    assert tuple(GR.build_cell("ogb_products", None, False).args[2]["edges"].shape) == (
        61859328, 2)


def test_registry_lists_the_gnn():
    arch, jarch = configs.get("graphsage-reddit"), jconfigs.get("graphsage-reddit")
    assert (arch.id, arch.kind, arch.shapes, arch.notes) == (
        jarch.id, jarch.kind, jarch.shapes, jarch.notes)
    assert arch.kind == "gnn" and len(configs.list_archs()) == 13


def test_smoke_on_the_cpu():
    out = configs.get("graphsage-reddit").smoke("cpu")
    assert np.isfinite(out["loss"]) and out["logits_shape"] == (4, 5)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")


def test_smoke_and_init_refuse_a_missing_card(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        configs.get("graphsage-reddit").smoke()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        G.init_params(G.GNNConfig(name="t"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        G.params_from_numpy({"out": np.zeros((2, 2), np.float32)}, "cuda")
