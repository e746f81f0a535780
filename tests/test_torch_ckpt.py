"""repro_torch's CheckpointManager against the JAX package's, on the CPU.

The reference's four checkpoint tests (tests/test_optim_ckpt.py) run as the
cases of one test through the port's manager; a checkpoint written by either
package restores in the other bit for bit, and the next train steps of both
agree (rtol 1e-5, atol 1e-6: f32, XLA's and PyTorch's summation orders).
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models import recsys as JR
from repro.optim import optimizers as JO
from repro_torch.ckpt.checkpoint import CheckpointManager, PartitionSpec
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.launch import mesh as M
from repro_torch.models import recsys as R
from repro_torch.optim import optimizers as O
from repro_torch.optim import sharding_rules as SR
from repro_torch.utils import keystr, tree_flatten_with_path

import _torch_sharded_ranks as ranks
from test_torch_train import _cfgs, _jax_batch, _torch_batch, assert_trees_close


def _roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4)}, "t": torch.tensor(7, dtype=torch.int32)}
    mgr.save(3, tree, extra={"step": 3, "data_pos": 42}, blocking=True)
    template = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)},
                "t": torch.zeros((), dtype=torch.int32)}
    restored, extra = mgr.restore(template)
    assert extra["data_pos"] == 42
    for (pa, a), (pb, b) in zip(tree_flatten_with_path(tree), tree_flatten_with_path(restored)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def _gc_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.ones(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, extra={"step": s}, blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def _atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.ones(2)}, extra={"step": 1}, blocking=True)
    # a stale .tmp dir from a crashed save must not shadow the good one
    (pathlib.Path(tmp_path) / "step_2.tmp").mkdir()
    assert mgr.latest_step() == 1


def _shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.ones(2)}, extra={}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros(3)})


@pytest.mark.parametrize("case", [_roundtrip, _gc_and_latest, _atomicity,
                                  _shape_mismatch_raises],
                         ids=["roundtrip", "gc_and_latest", "atomicity", "shape_mismatch_raises"])
def test_checkpoint(case, tmp_path):
    case(tmp_path)


def test_save_copies_before_returning(tmp_path):
    """The snapshot is taken before ``save`` returns: changing a leaf in
    place afterwards does not reach the file."""
    mgr = CheckpointManager(tmp_path)
    leaf = torch.ones(1000)
    mgr.save(0, {"a": leaf}, extra={"step": 0})
    leaf.mul_(3.0)
    mgr.wait()
    restored, _ = mgr.restore({"a": torch.zeros(1000)})
    assert torch.equal(restored["a"], torch.ones(1000))


def test_manifest_matches_the_references(tmp_path):
    """The same tree and specs give the same manifest (keys, files, shapes,
    dtypes, specs), apart from the save time."""
    np_tree = ({"emb": {"table": np.ones((4, 2), np.float32)},
                "bottom": {"w0": np.zeros((2, 3), np.float32)}},
               [{"m": [np.zeros(3, np.float32)], "t": np.array(5, np.int32)}])
    specs = {"emb": {"table": P("model", None)}, "bottom": {"w0": P(None, ("data", "model"))}}
    JaxCheckpointManager(tmp_path / "jax").save(2, jax.tree_util.tree_map(jnp.asarray, np_tree),
                                                specs=(specs, None), extra={"step": 2},
                                                blocking=True)
    tspecs = {"emb": {"table": PartitionSpec("model", None)},
              "bottom": {"w0": PartitionSpec(None, ("data", "model"))}}
    CheckpointManager(tmp_path / "port").save(
        2, jax.tree_util.tree_map(torch.from_numpy, np_tree), specs=(tspecs, None),
        extra={"step": 2}, blocking=True)
    manifests = [json.loads((tmp_path / d / "step_2" / "manifest.json").read_text())
                 for d in ("jax", "port")]
    for m in manifests:
        m.pop("save_seconds")
    assert manifests[0] == manifests[1]
    assert [leaf["key"] for leaf in manifests[1]["leaves"]][:2] == \
        ["[0]['bottom']['w0']", "[0]['emb']['table']"]


class _ModelAxisOf4:
    """Rank 1 of a mesh of one axis, ``model`` of 4, for ``block_slices``."""

    def axis_size(self, axes):
        return 4

    def index(self, axes):
        return 1


def test_refusals(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(0, {"a": torch.ones(2, dtype=torch.bfloat16)}, blocking=True)
    mgr.save(1, {"a": torch.ones(2)}, blocking=True)
    with pytest.raises(ValueError, match="does not split 4 ways"):
        mgr.restore({"a": torch.zeros(2)}, mesh=_ModelAxisOf4(),
                    specs={"a": PartitionSpec("model")})
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.restore({"a": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"b": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"a": torch.zeros(2)})


def test_restore_into_abstract_params(tmp_path):
    """``abstract_params``' meta tensors are a template for shapes and dtypes
    only: without ``device=`` the restore raises rather than return meta
    tensors that hold none of the checkpoint; with it, every leaf comes back
    bit-equal."""
    cfg = R.RecsysConfig(name="t", arch="dlrm", tables=(
        TableSpec("big", 400, nnz=4), TableSpec("mid", 100, nnz=1)), embed_dim=8,
        n_dense=3, bottom_mlp=(8,), mlp=(8,))
    params = R.init_params(cfg, seed=3, num_shards=2, device="cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, params, blocking=True)
    with pytest.raises(ValueError, match="meta device"):
        mgr.restore(R.abstract_params(cfg, 2))
    with pytest.raises(ValueError, match="meta device"):
        mgr.restore(params, device="meta")
    restored, _ = mgr.restore(R.abstract_params(cfg, 2), device="cpu")
    for (pa, a), (pb, b) in zip(tree_flatten_with_path(params),
                                tree_flatten_with_path(restored)):
        assert pa == pb and b.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b), keystr(pa)


def _train_setup():
    jcfg, tcfg = _cfgs("mean_replicated")
    np_params = jax.tree_util.tree_map(np.array, JR.init_params(jcfg, jax.random.key(3)))
    rng = np.random.default_rng(11)
    batches = [syn.recsys_batch(rng, tcfg.tables, 32, n_dense=13) for _ in range(4)]
    mix = lambda m: m.make_composite(  # noqa: E731
        [("emb", m.make_rowwise_adagrad(0.05)), (".*", m.make_adam(1e-3))])
    return jcfg, tcfg, np_params, batches, mix(JO), mix(O)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages(writer, tmp_path):
    """Two steps in the writing package, a checkpoint of (params, state),
    a restore in the other package into its own freshly made template, then
    two more steps in both: the restored leaves are bit-equal to the saved
    ones and the next steps agree."""
    jcfg, tcfg, np_params, batches, jopt, topt = _train_setup()
    jstep = jax.jit(JR.make_train_step(jcfg, jopt, None))
    tstep = R.make_train_step(tcfg, topt)
    if writer == "reference":
        jp = jax.tree_util.tree_map(jnp.asarray, np_params)
        js = jopt.init(jp)
        for b in batches[:2]:
            jp, js, _ = jstep(jp, js, _jax_batch(b))
        JaxCheckpointManager(tmp_path).save(1, (jp, js), extra={"step": 1}, blocking=True)
        tp = R.init_params(tcfg, seed=5, device="cpu")
        (tp, ts), extra = CheckpointManager(tmp_path).restore((tp, topt.init(tp)))
    else:
        tp = R.params_from_numpy(np_params, "cpu")
        ts = topt.init(tp)
        for b in batches[:2]:
            tp, ts, _ = tstep(tp, ts, _torch_batch(b))
        CheckpointManager(tmp_path).save(1, (tp, ts), extra={"step": 1}, blocking=True)
        jp0 = jax.tree_util.tree_map(jnp.asarray, np_params)
        (jp, js), extra = JaxCheckpointManager(tmp_path).restore((jp0, jopt.init(jp0)))
    assert extra == {"step": 1}
    jflat, _ = jax.tree_util.tree_flatten_with_path((jp, js))
    tflat = tree_flatten_with_path((tp, ts))
    assert [keystr(p) for p, _ in tflat] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (_, t), (_, j) in zip(tflat, jflat):
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for b in batches[2:]:
        jp, js, jm = jstep(jp, js, _jax_batch(b))
        tp, ts, tm = tstep(tp, ts, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6)
    assert_trees_close((tp, ts), (jp, js), 1e-5, 1e-6)


def test_restore_under_a_mesh_and_back(tmp_path):
    """A checkpoint of params and optimizer state saved by one process
    restores on 4 gloo ranks of a (data 2, model 2) mesh, each rank holding
    its block of every leaf (rows of the table and of its accumulator by the
    model axis; the rest whole) bit for bit; saved again from the mesh
    (gathered, rank 0 writes), it restores in one process bit-equal to the
    first."""
    cfg = R.RecsysConfig(name="t", arch="dlrm", tables=(
        TableSpec("big", 4000, nnz=4), TableSpec("mid", 1000, nnz=1)), embed_dim=8,
        n_dense=3, bottom_mlp=(8,), mlp=(8,))
    params = R.init_params(cfg, seed=3, num_shards=2, device="cpu")
    opt = ranks.optimizer()
    state = opt.init(params)
    b = syn.recsys_batch(np.random.default_rng(0), cfg.tables, 8, n_dense=3)
    params, state, _ = R.make_train_step(cfg, opt)(params, state, _torch_batch(b))
    pspecs = R.param_specs(cfg, 2)
    CheckpointManager(tmp_path).save(1, (params, state), specs=(pspecs, None),
                                     extra={"step": 1}, blocking=True)
    out = M.spawn(ranks.restore_rank, 4, (str(tmp_path), (2, 2)), timeout=120)
    state_specs = SR.composite_state_specs([("emb", "rowwise"), (".*", "adam")], pspecs,
                                           R.abstract_params(cfg, 2))
    whole = {"params": dict(tree_flatten_with_path(params)),
             "state": dict(tree_flatten_with_path(state))}
    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    spec_of = {"params": dict(tree_flatten_with_path(pspecs, is_spec)),
               "state": dict(tree_flatten_with_path(state_specs, is_spec))}
    for r in out:
        m = r["coords"]["model"]
        for part in ("params", "state"):
            for path, leaf in whole[part].items():
                want = leaf.numpy()
                if spec_of[part][path].axes_of(0) == ("model",):
                    n = want.shape[0] // 2
                    want = want[m * n:(m + 1) * n]
                got = r[part][keystr(path)]
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want, err_msg=keystr(path))
    assert sum(spec_of["params"][p].axes_of(0) == ("model",) for p in whole["params"]) == 1
    (p2, s2), extra = CheckpointManager(tmp_path).restore((params, state), step=2)
    assert extra == {"step": 1}
    for (pa, a), (pb, b_) in zip(tree_flatten_with_path((params, state)),
                                 tree_flatten_with_path((p2, s2))):
        assert pa == pb and a.dtype == b_.dtype and torch.equal(a, b_)
