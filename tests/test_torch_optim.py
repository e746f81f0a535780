"""repro_torch's optimizers against the JAX package's, on the CPU.

The same params and gradients, seeded numpy, go through both packages for
one and three steps; params and every state leaf are compared by key
(``utils.keystr`` against ``jax.tree_util.keystr``).  Tolerance: f32 on both
sides, rtol 1e-5, atol 1e-6 (XLA's and PyTorch's elementwise kernels round
rsqrt and means differently, by an ulp or so).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as JP

from repro.optim import grad_compress as JGC
from repro.optim import optimizers as JO
from repro.optim import sharding_rules as JSR
from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.launch import mesh as M
from repro_torch.optim import grad_compress as GC
from repro_torch.optim import optimizers as O
from repro_torch.optim import sharding_rules as SR
from repro_torch.utils import keystr, tree_flatten_with_path, tree_unflatten

import _torch_sharded_ranks as ranks

RTOL, ATOL = 1e-5, 1e-6

SHAPES = {"emb": {"table": (10, 4)},
          "mlp": [{"w": (4, 6), "b": (6,)}, {"w": (6, 3), "b": (3,)}],
          "stack": (3, 5, 4), "bias": (5,)}


def _np_tree(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _np_tree(rng, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_np_tree(rng, v) for v in shapes]
    return rng.normal(size=shapes).astype(np.float32)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    """Same key strings in the same order, leaves allclose with equal dtypes."""
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    tflat = tree_flatten_with_path(got)
    assert [keystr(p) for p, _ in tflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, t), (_, j) in zip(tflat, jflat):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, keystr(path)
        np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=atol, err_msg=keystr(path))


OPTIMIZERS = {
    "sgd": lambda m: m.make_sgd(0.1),
    "sgd_momentum": lambda m: m.make_sgd(0.05, momentum=0.9),
    "adam": lambda m: m.make_adam(0.05),
    "adam_weight_decay": lambda m: m.make_adam(0.01, weight_decay=0.1),
    "adafactor": lambda m: m.make_adafactor(0.5),
    "rowwise_adagrad": lambda m: m.make_rowwise_adagrad(0.5),
    "composite": lambda m: m.make_composite(
        [("emb", m.make_rowwise_adagrad(0.05)), (r"\['stack'\]", m.make_adafactor(0.1)),
         (".*", m.make_adam(1e-3))]),
}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference(name, steps):
    rng = np.random.default_rng(0)
    params = _np_tree(rng, SHAPES)
    grads = [_np_tree(rng, SHAPES) for _ in range(steps)]
    jopt, topt = OPTIMIZERS[name](JO), OPTIMIZERS[name](O)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert_trees_close(ts, js)
    for g in grads:
        jp, js = jopt.update(_to_jax(g), js, jp)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    assert_trees_close(tp, jp)
    assert_trees_close(ts, js)
    assert list(tp) == list(params)  # the params' own key order is kept


def test_update_leaves_its_arguments_unchanged():
    rng = np.random.default_rng(1)
    params, grads = _to_torch(_np_tree(rng, SHAPES)), _to_torch(_np_tree(rng, SHAPES))
    opt = OPTIMIZERS["composite"](O)
    state = opt.init(params)
    copies = [t.clone() for _, t in tree_flatten_with_path((params, grads, state))]
    opt.update(grads, state, params)
    for (_, t), c in zip(tree_flatten_with_path((params, grads, state)), copies):
        assert torch.equal(t, c)


def test_adafactor_stacked_matches_unstacked():
    """The loop over the leading dim equals per-layer updates (the
    reference's own check), and the stacked update equals the reference's."""
    rng = np.random.default_rng(2)
    stacked = rng.normal(size=(3, 4, 5)).astype(np.float32)
    g = rng.normal(size=(3, 4, 5)).astype(np.float32)
    opt = O.make_adafactor(0.1)
    p1, s1 = opt.update({"w": torch.from_numpy(g)}, opt.init({"w": torch.from_numpy(stacked)}),
                        {"w": torch.from_numpy(stacked)})
    outs = []
    for i in range(3):
        pi = {"w": torch.from_numpy(stacked[i])}
        outs.append(opt.update({"w": torch.from_numpy(g[i])}, opt.init(pi), pi)[0]["w"])
    np.testing.assert_allclose(p1["w"].numpy(), torch.stack(outs).numpy(), rtol=1e-5, atol=1e-6)
    jopt = JO.make_adafactor(0.1)
    jp, js = jopt.update({"w": jnp.asarray(g)}, jopt.init({"w": jnp.asarray(stacked)}),
                         {"w": jnp.asarray(stacked)})
    assert_trees_close(p1, jp)
    assert_trees_close(s1, js)


def test_composite_routes_by_key_path():
    """First match wins, over the reference's key strings; the state is a
    list with one entry per rule, and a leaf no rule matches raises."""
    params = {"emb": {"table": torch.ones(10, 4)}, "mlp": {"w0": torch.ones(4, 4)},
              "w_emb": torch.ones(3)}
    opt = O.make_composite([("emb", O.make_rowwise_adagrad(0.1)), (".*", O.make_adam(0.1))])
    state = opt.init(params)
    assert [s.shape for s in state[0]] == [(10,), (3,)]  # ['emb']['table'], ['w_emb']
    assert [m.shape for m in state[1]["m"]] == [(4, 4)]
    grads = tree_unflatten(params, [torch.ones_like(t) for _, t in
                                    tree_flatten_with_path(params)])
    new, state2 = opt.update(grads, state, params)
    assert new["emb"]["table"].shape == (10, 4)
    assert state2[0][0].shape == (10,)
    assert int(state2[1]["t"]) == 1
    with pytest.raises(ValueError, match="no optimizer rule matches"):
        O.make_composite([("emb", O.make_sgd(0.1))]).init(params)


def test_optimizers_descend():
    """The reference's quadratic descent check, through the port."""
    rng = np.random.default_rng(3)
    for name in OPTIMIZERS:
        opt = OPTIMIZERS[name](O)
        params = _to_torch(_np_tree(rng, SHAPES))
        leaves = lambda p: [t for _, t in tree_flatten_with_path(p)]  # noqa: E731
        loss = lambda p: sum(float((t ** 2).sum()) for t in leaves(p))  # noqa: E731
        l0, state = loss(params), opt.init(params)
        for _ in range(25):
            grads = tree_unflatten(params, [2 * t for t in leaves(params)])
            params, state = opt.update(grads, state, params)
        assert loss(params) < 0.9 * l0, name


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(4)
    grads = _np_tree(rng, SHAPES)
    jc, jn = JO.clip_by_global_norm(_to_jax(grads), max_norm)
    tc, tn = O.clip_by_global_norm(_to_torch(grads), max_norm)
    assert tn.shape == () and tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    assert_trees_close(tc, jc)
    if max_norm == 1.0:
        norm = float(torch.sqrt(sum((t ** 2).sum() for _, t in tree_flatten_with_path(tc))))
        assert norm <= 1.0 + 1e-5


def test_flatten_order_and_key_strings_match_jax():
    tree = ({"emb": {"table": 1}, "bottom": {"w0": 2, "b0": 3, "w10": 4, "w2": 5}},
            [[6], {"m": [7], "v": [8], "t": 9}, (), None], {"k": (10, 11)})
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    flat = tree_flatten_with_path(tree)
    assert [(keystr(p), leaf) for p, leaf in flat] == \
        [(jax.tree_util.keystr(p), leaf) for p, leaf in jflat]
    back = tree_unflatten(tree, [leaf * 10 for _, leaf in flat])
    assert list(back[0]) == ["emb", "bottom"] and back[0]["bottom"]["w10"] == 40
    assert back[1][2] == () and back[1][3] is None and back[2]["k"] == (100, 110)
    with pytest.raises(ValueError, match="fewer"):
        tree_unflatten(tree, [1])
    with pytest.raises(ValueError, match="more"):
        tree_unflatten(tree, list(range(12)))


# the params of SHAPES laid out on a (data, model) mesh: the table's rows on
# model, a matrix split over both axes on its columns, the rest replicated
PSPECS = {"emb": {"table": ("model", None)},
          "mlp": [{"w": (None, ("data", "model")), "b": (None,)}, {"w": (None, None), "b": ()}],
          "stack": ("data", None, None), "bias": (None,)}
RULES = {
    "adam": lambda m, ps, sh: m.adam_state_specs(ps, sh),
    "sgd": lambda m, ps, sh: m.sgd_state_specs(ps, sh),
    "sgd_momentum": lambda m, ps, sh: m.sgd_state_specs(ps, sh, momentum=0.9),
    "adafactor": lambda m, ps, sh: m.adafactor_state_specs(ps, sh),
    "rowwise_adagrad": lambda m, ps, sh: m.rowwise_adagrad_state_specs(ps, sh),
    "composite": lambda m, ps, sh: m.composite_state_specs(
        [("emb", "rowwise"), (r"\['stack'\]", "adafactor"), (".*", "adam")], ps, sh),
}


def _specs(tree, cls):
    if isinstance(tree, dict):
        return {k: _specs(v, cls) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(v, cls) for v in tree]
    return cls(*tree)


def _as_tuples(tree):
    """Spec trees of either package as nested plain data, specs as tuples."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, (P, JP)):
        return ("spec",) + tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in tree)
    if isinstance(tree, (list, tuple)):
        return [_as_tuples(v) for v in tree]
    return tree


@pytest.mark.parametrize("rule", sorted(RULES))
def test_state_specs_match_reference(rule):
    """Optimizer-state specs from the parameter specs, as the reference
    derives them: Adam's moments inherit the param's spec, rowwise Adagrad
    keeps the row axis, Adafactor drops the reduced one."""
    shapes = _np_tree(np.random.default_rng(0), SHAPES)
    got = RULES[rule](SR, _specs(PSPECS, P), _to_torch(shapes))
    want = RULES[rule](JSR, _specs(PSPECS, JP), jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), shapes))
    assert _as_tuples(got) == _as_tuples(want)
    opt = OPTIMIZERS.get(rule)
    if opt is not None:  # the specs are shaped as the optimizer's state
        state = opt(O).init(_to_torch(shapes))
        assert len(tree_flatten_with_path(state)) == len(
            tree_flatten_with_path(got, lambda x: isinstance(x, P)))


def test_int8_codec_matches_reference_bit_for_bit():
    """Three rounds of encode with error feedback, then decode: payload,
    scales, residuals and decoded values equal the reference's bits (round
    half to even on both; a row of zeros takes the 1e-12 floor)."""
    rng = np.random.default_rng(7)
    jres = tres = None
    for i in range(3):
        x = rng.normal(size=(6, 5, 3)).astype(np.float32)
        x[2] = 0.0
        x[4, 0, 0] = 127.5 * (i + 1)  # ties at the row's maximum scale
        jcoded, jres = JGC.int8_encode(jnp.asarray(x), jres)
        tcoded, tres = GC.int8_encode(torch.from_numpy(x), tres)
        for got, want in ((tcoded.q, jcoded.q), (tcoded.scale, jcoded.scale), (tres, jres),
                          (GC.int8_decode(tcoded), JGC.int8_decode(jcoded))):
            assert got.numpy().dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert GC.compressed_bytes(torch.from_numpy(x)) == JGC.compressed_bytes(jnp.asarray(x))


def test_compress_psum_over_two_ranks():
    """The bf16 all-reduce of two gloo ranks: the sum of the bf16 payloads,
    cast back to f32, and half the f32 bytes on the wire."""
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    out = M.spawn(ranks.compress_psum_rank, 2, (x,), timeout=60)
    t = torch.from_numpy(x)
    want = (t.to(torch.bfloat16) + (2 * t).to(torch.bfloat16)).to(torch.float32)
    for r in out:
        assert r["sum"].dtype == np.float32
        np.testing.assert_array_equal(r["sum"], want.numpy())
        assert r["bytes"] == {"all_reduce": 2 * x.size * 2 * (2 - 1) / 2}
