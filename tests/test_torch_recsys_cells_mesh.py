"""The seven recsys registry ids' cells under a real mesh, on the CPU.

Each of the 28 cells (autoint, dcn-v2, deepfm, dlrm-flexemr, mind,
two-tower-retrieval and wide-deep x train_batch, serve_p99, serve_bulk and
retrieval_cand) runs at its published widths: fields, embedding dims, bag
sizes, MLPs, attention and cross layers, history length and interests.  Two
things are cut, the same way on both sides: every table's rows to
``ROW_CAP`` (divisible by the shard count), and the batches to ``BATCHES``
and ``N_CANDIDATES`` candidates (``recsys_common.RECSYS_SHAPES`` and
``N_CANDIDATES`` patched in both processes).

The reference runs in a subprocess with 8 forced host devices
(``tests/_jax_recsys_cells_reference.py``): each cell from its own
``build_cell``, jitted with the cell's ``in_shardings`` under its (data 2,
model 4) mesh.  At the same time the port runs on 8 gloo ranks of the same
mesh (``tests/_torch_recsys_cells_ranks.py`` through ``launch.mesh.spawn``):
each rank takes its blocks of the cell's global arguments by the cell's
``in_shardings`` (``CellBuild.blocks``) and calls ``cell.step_fn``.  The
params are the reference's ``init_params`` (mind's item table scaled to
N(0, 1), as tests/test_torch_recsys_archs.py scales it), carried across as
numpy arrays; batches are seeded numpy.

Held per rank: a serve cell's block of the scores (rtol 1e-5, atol 1e-6);
a train cell's loss (1e-5 / 1e-6), its gradients through an optimizer that
returns them (rtol 1e-5, atol 1e-6 times the leaf's largest magnitude past
1), and its params and optimizer-state blocks after the cell's one step
(``STEP_TOL``: Adam's first step divides a gradient by its own magnitude);
a retrieval cell's top-k values (allclose) and indices (equal; the scores
are tie-free).  Each rank's ``comm.bytes.*`` equal the ring model's
formula (``_ring_bytes``) and the collective bytes the reference's
compiled cell moves, but for the differences ``_xla_differences`` names;
a rank's part of each cell traced on meta under a ``DryMesh`` counts the
bytes and calls each rank counted.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import recsys as JR
from repro_torch.configs import recsys_common as RC
from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.data import synthetic as syn
from repro_torch.launch import mesh as M
from repro_torch.models import recsys as R
from repro_torch.utils import keystr, tree_flatten_with_path, tree_map, tree_unflatten

import _jax_recsys_cells_reference as reference
import _torch_recsys_cells_ranks as ranks

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
STEP_TOL = (1e-4, 1e-6)  # params and state after an Adam step, as test_torch_sharded.py's
REF_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 300
MESH = (2, 4)  # (data, model)
IDS = ["autoint", "dcn-v2", "deepfm", "dlrm-flexemr", "mind", "two-tower-retrieval",
       "wide-deep"]
SHAPES = list(RC.RECSYS_SHAPES)
ROW_CAP = 4096  # rows a table; mind's retrieval scores each of its items once
BATCHES = {"train_batch": 64, "serve_p99": 32, "serve_bulk": 128}
N_CANDIDATES = 4096
TT_QUERIES = 8  # the two-tower retrieval cell's queries (recsys_common's)
META = dict(mesh=list(MESH), ids=IDS, shapes=SHAPES, row_cap=ROW_CAP, batches=BATCHES,
            n_candidates=N_CANDIDATES)
CELLS = [(a, s) for a in IDS for s in SHAPES]


def _kind(shape: str) -> str:
    return RC.RECSYS_SHAPES[shape]["kind"]


def _path_key(path) -> str:
    return "|".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _batch(rng, cfg, shape: str) -> dict:
    """One batch of the cell's keys (``recsys_common.batch_abstract``'s)."""
    if _kind(shape) == "retrieval":
        N = N_CANDIDATES
        if cfg.arch == "two_tower":
            b = syn.recsys_batch(rng, cfg.tables, TT_QUERIES)
            return {k: b[k] for k in ("indices", "mask")}
        if cfg.arch == "mind":
            b = syn.mind_batch(rng, cfg.tables[0].vocab, 1, cfg.hist_len)
            return {"hist": b["hist"], "hist_mask": b["hist_mask"],
                    "cand_ids": rng.permutation(cfg.tables[0].vocab)[:N].astype(np.int32)}
        B = N
    else:
        B = BATCHES[shape]
    train = _kind(shape) == "train"
    if cfg.arch == "mind":
        b = syn.mind_batch(rng, cfg.tables[0].vocab, B, cfg.hist_len)
    else:
        b = syn.recsys_batch(rng, cfg.tables, B, n_dense=cfg.n_dense)
    keys, _ = RC.batch_abstract(cfg, B, ("data",), train)
    return {k: b[k] for k in keys}


def _inputs() -> dict:
    """The reference's params of each id (capped tables, 4 shards; mind's
    item table times 100), each cell's batch and the two-tower retrieval's
    candidates, from one seeded stream."""
    rng = np.random.default_rng(0)
    d = {"meta": np.array(json.dumps(META))}
    for i, arch_id in enumerate(IDS):
        jcfg = reference.capped_config(arch_id, ROW_CAP)
        cfg = ranks.capped_config(arch_id, ROW_CAP)
        params = JR.init_params(jcfg, jax.random.key(i), num_shards=MESH[1])
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        for path, x in flat:
            x = np.asarray(x)
            if cfg.arch == "mind" and _path_key(path) == "emb|table":
                x = x * np.float32(100.0)
            d[f"params|{arch_id}|{_path_key(path)}"] = x
        for shape in SHAPES:
            for k, v in _batch(rng, cfg, shape).items():
                d[f"batch|{arch_id}|{shape}|{k}"] = v
        if cfg.arch == "two_tower":
            d[f"cands|{arch_id}"] = rng.standard_normal((N_CANDIDATES, cfg.mlp[-1])).astype(
                np.float32)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, the ranks' counts, the ranks' outputs): the
    reference's subprocess and the port's 8 ranks run at the same time on
    the same inputs."""
    tmp = tmp_path_factory.mktemp("recsys_cells")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = str(ROOT / "tests" / "_jax_recsys_cells_reference.py")
    ref = subprocess.Popen([sys.executable, script, str(inputs), str(tmp / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        counted = M.spawn(ranks.run, MESH[0] * MESH[1], (str(inputs), str(tmp)),
                          timeout=SPAWN_TIMEOUT_S)
        err = ref.communicate(timeout=REF_TIMEOUT_S)[1]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    outs = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(counted))]
    return dict(np.load(tmp / "ref.npz")), counted, outs, dict(np.load(inputs))



class _Coords:
    """A rank's place on the mesh, for ``M.block_slices`` on numpy arrays."""

    def __init__(self, coords: dict):
        self.coords, self.shape = coords, dict(zip(("data", "model"), MESH))

    def axis_size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def _block(arr: np.ndarray, spec: P, coords: dict) -> np.ndarray:
    return arr[M.block_slices(arr.shape, spec, _Coords(coords))]


def _close(got, want, tol=(RTOL, ATOL)):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol[0], atol=tol[1])


def _specs(arch_id: str, shape: str) -> tuple[dict, dict]:
    """``{keystr: spec}`` of the params and of the optimizer state of the
    cell (``in_shardings[0]`` and ``[1]``)."""
    cell = RC._build(shape, M.AbstractMesh(MESH, ("data", "model")), False,
                     cfg_fn=lambda: ranks.capped_config(arch_id, ROW_CAP))
    return tuple({keystr(p): s for p, s in tree_flatten_with_path(
        cell.in_shardings[i], lambda x: isinstance(x, P))} for i in (0, 1))


def _leaves(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


@pytest.mark.parametrize("arch_id", IDS)
@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_serve_cell_matches_reference(runs, arch_id, shape):
    """Each rank's block of the scores (the batch over data x model) against
    the reference's compiled cell.  Two-tower's score is a cosine over the
    temperature (0.05): atol 1e-6 on the cosine is 2e-5 on the score
    (serve_bulk's scores sit 3.0e-6 from an f64 forward on the reference's
    side and 2.6e-6 on the port's)."""
    ref, counted, outs, inputs = runs
    key = f"{arch_id}|{shape}"
    want = ref[f"scores|{key}"]
    assert want.shape == (BATCHES[shape],) and np.isfinite(want).all()
    atol = ATOL
    if arch_id == "two-tower-retrieval":
        atol = ATOL / float(inputs[f"params|{arch_id}|temp"])
    for c, out in zip(counted, outs):
        got = out[f"scores|{key}"]
        assert got.shape == (BATCHES[shape] // (MESH[0] * MESH[1]),)
        _close(got, _block(want, P(("data", "model")), c["coords"]), (RTOL, atol))


@functools.lru_cache(maxsize=None)
def _reference_optimizer():
    """(init, jitted update) of the reference's ``make_recsys_optimizer``."""
    from repro.configs import recsys_common as JRC

    opt = JRC.make_recsys_optimizer()
    return opt.init, jax.jit(opt.update)


def _reference_step(params, grads: dict) -> dict:
    """``{"params|<keystr>": .., "state|<keystr>": ..}`` of the reference's
    ``make_recsys_optimizer`` stepping ``params`` (a rank's blocks, nested
    torch tensors) by ``grads`` (its gradient blocks by keystr) from its
    initial state."""
    import jax.numpy as jnp

    paths = [p for p, _ in tree_flatten_with_path(params)]
    g = tree_unflatten(params, [grads[keystr(p)] for p in paths])
    to_jax = functools.partial(tree_map, lambda t: jnp.asarray(np.asarray(t)))
    p = to_jax(params)
    init, update = _reference_optimizer()
    new_p, new_s = update(to_jax(g), init(p), p)
    return {f"{what}|{jax.tree_util.keystr(k)}": np.asarray(v)
            for what, tree in (("params", new_p), ("state", new_s))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch_id", IDS)
def test_train_cell_matches_reference(runs, arch_id):
    """The loss; every gradient block (an optimizer that returns the
    gradients; atol times the leaf's largest magnitude past 1); the cell's
    step (rowwise AdaGrad on the tables, Adam elsewhere) laid out by its
    ``in_shardings``: the optimizer-state blocks against the reference's
    step, and the param blocks against the reference's optimizer applied to
    the rank's own gradient blocks, both at ``STEP_TOL``.  (Adam's first
    step is lr g / (|g| + 1e-8): where a gradient sits near 1e-8 it turns
    the gradients' rounding, within their tolerance, into a step apart: 28
    entries of two-tower's towers, one of dcn-v2's deep MLP.)"""
    ref, counted, outs, inputs = runs
    key = f"{arch_id}|train_batch"
    pspecs, sspecs = _specs(arch_id, "train_batch")
    cell = RC._build("train_batch", M.AbstractMesh(MESH, ("data", "model")), False,
                     cfg_fn=lambda: ranks.capped_config(arch_id, ROW_CAP))
    whole = ranks.nest(inputs, f"params|{arch_id}")
    assert np.isfinite(ref[f"loss|{key}"])
    for c, out in zip(counted, outs):
        _close(out[f"loss|{key}"], ref[f"loss|{key}"])
        _close(out[f"grads_loss|{key}"], ref[f"grads_loss|{key}"])
        grads = _leaves(out, f"grads|{key}|")
        assert sorted(grads) == sorted(pspecs)
        for leaf, spec in pspecs.items():
            want = _block(ref[f"grads|{key}|{leaf}"], spec, c["coords"])
            assert grads[leaf].shape == want.shape, leaf
            scale = max(1.0, float(np.abs(want).max(initial=0.0)))
            _close(grads[leaf], want, (RTOL, ATOL * scale))
        stepped = _reference_step(R.shard_params(whole, cell.in_shardings[0],
                                                 _Coords(c["coords"])), grads)
        for what, specs in (("params", pspecs), ("state", sspecs)):
            got = _leaves(out, f"{what}|{key}|")
            assert sorted(got) == sorted(specs), what
            for leaf, spec in specs.items():
                want = (stepped[f"params|{leaf}"] if what == "params" else
                        _block(ref[f"state|{key}|{leaf}"], spec, c["coords"]))
                assert got[leaf].shape == want.shape, (what, leaf)
                _close(got[leaf], want, STEP_TOL)


@pytest.mark.parametrize("arch_id", IDS)
def test_retrieval_cell_matches_reference(runs, arch_id):
    """The global top-k on every rank: values allclose, indices equal (the
    reference's top scores are distinct, and each gap between them passes
    the largest difference of a rank's values from the reference's)."""
    ref, counted, outs, _ = runs
    key = f"{arch_id}|retrieval_cand"
    want_v, want_i = ref[f"values|{key}"], ref[f"indices|{key}"]
    assert want_v.shape[-1] == RC.RETRIEVAL_K and np.isfinite(want_v).all()
    gaps = -np.diff(want_v, axis=-1)
    assert (gaps > max(np.abs(out[f"values|{key}"] - want_v).max() for out in outs)).all()
    for out in outs:
        _close(out[f"values|{key}"], want_v)
        np.testing.assert_array_equal(out[f"indices|{key}"], want_i)
        assert out[f"indices|{key}"].dtype == np.int32



@pytest.mark.parametrize("arch_id, shape",
                         [(a, s) for a, s in CELLS if _kind(s) != "train"])
def test_one_device_cell_matches_reference(runs, monkeypatch, arch_id, shape):
    """Each serve and retrieval cell built with ``mesh=None`` (one device's
    cell, the reference of ``chip_smoke.py`` phase 5g2) on the whole
    arguments against the reference's compiled cell under its mesh."""
    ref, _, _, inputs = runs
    for name, batch in BATCHES.items():
        monkeypatch.setitem(RC.RECSYS_SHAPES[name], "batch", batch)
    monkeypatch.setitem(RC.RECSYS_SHAPES["retrieval_cand"], "n_candidates", N_CANDIDATES)
    cfg = ranks.capped_config(arch_id, ROW_CAP)
    cell = RC._build(shape, None, False, cfg_fn=lambda: cfg)
    # the one-device layout's tables: the rows without the shard count's padding
    params = ranks.nest(inputs, f"params|{arch_id}")
    for key, emb in (("emb", cfg.embedding(1)), ("wide", cfg.wide_embedding(1))):
        if key in params:
            params[key] = {"table": params[key]["table"][:emb.sharded.total_rows]}
    with torch.no_grad():
        out = cell.step_fn(*ranks.cell_args(inputs, arch_id, shape, cell, params))
    key = f"{arch_id}|{shape}"
    if _kind(shape) == "serve":
        atol = ATOL / float(inputs[f"params|{arch_id}|temp"]) if cfg.arch == "two_tower" else ATOL
        _close(out, ref[f"scores|{key}"], (RTOL, atol))
    else:
        _close(out[0], ref[f"values|{key}"])
        np.testing.assert_array_equal(out[1], ref[f"indices|{key}"])


# ------------------------------------------------ collective bytes, by formula


def _ar(nbytes: float, g: int) -> float:
    return 2 * nbytes * (g - 1) / g


def _ag(out_bytes: float, g: int) -> float:
    return out_bytes * (g - 1) / g


def _rs(out_bytes: float, g: int) -> float:
    return out_bytes * (g - 1)


def _leaf_bytes(arch_id: str) -> tuple[float, dict]:
    """(the dense leaves' bytes, each table's block bytes on one rank)."""
    cfg = ranks.capped_config(arch_id, ROW_CAP)
    dense, tables = 0.0, {}
    for path, t in tree_flatten_with_path(R.abstract_params(cfg, MESH[1])):
        n = t.numel() * t.element_size()
        if path[0] in ("emb", "wide"):
            tables[path[0]] = n / MESH[1]
        else:
            dense += n
    return dense, tables


def _ring_bytes(arch_id: str, shape: str) -> dict:
    """One rank's bytes of the cell under the (data 2, model 4) mesh by the
    ring model, f32.  Each lookup: an all-reduce over model of the data
    rank's pooled [B_l, F, D] (the separate wide table's [B_l, F, 8]
    too; mind's raw history rows [B_l, H, D] and target rows [B_l, D]).
    The dense stage runs on this rank's B / 8 rows and moves nothing.
    Train: the lookups' transposes, the loss's all-reduce over the mesh,
    each table block's gradient summed over data and each dense leaf's over
    the mesh; two-tower all-gathers the item vectors [B, d] and
    reduce-scatters their cotangent; mind all-gathers every rank's last
    score (the BPR negative) and reduce-scatters its cotangent.  Retrieval:
    the lookups at the candidates' batch (two-tower's 8 queries whole on
    every rank, mind's history whole and its candidates over data), then
    each rank's top k values and int32 positions all-gathered over the
    candidates' axes."""
    cfg = ranks.capped_config(arch_id, ROW_CAP)
    dp, tp = MESH
    world = dp * tp
    F, D, K = cfg.num_fields, cfg.embed_dim, RC.RETRIEVAL_K
    out: dict = {}

    def add(op: str, v: float) -> None:
        out[op] = out.get(op, 0) + v

    def topk(rows: int, n_loc: int, g: int) -> None:
        add("all_gather", 2 * _ag(rows * min(K, n_loc) * g * 4, g))

    if _kind(shape) == "retrieval" and cfg.arch == "two_tower":
        add("all_reduce", _ar(TT_QUERIES * F * D * 4, tp))
        topk(TT_QUERIES, N_CANDIDATES // world, world)
        return out
    if _kind(shape) == "retrieval" and cfg.arch == "mind":
        add("all_reduce", _ar(cfg.hist_len * D * 4, tp) + _ar(N_CANDIDATES // dp * D * 4, tp))
        topk(1, N_CANDIDATES // dp, dp)
        return out
    B = N_CANDIDATES if _kind(shape) == "retrieval" else BATCHES[shape]
    bl = B // dp
    if cfg.arch == "mind":
        lookups = _ar(bl * cfg.hist_len * D * 4, tp) + _ar(bl * D * 4, tp)
    else:
        lookups = _ar(bl * F * D * 4, tp)
        if cfg.separate_wide:
            lookups += _ar(bl * F * R.WIDE_DIM * 4, tp)
    add("all_reduce", lookups)
    if _kind(shape) == "retrieval":
        topk(1, B // world, world)
    if _kind(shape) != "train":
        return out
    dense, tables = _leaf_bytes(arch_id)
    add("all_reduce", lookups + _ar(4, world) + _ar(dense, world)
        + sum(_ar(n, dp) for n in tables.values()))
    if cfg.arch == "two_tower":
        d = cfg.mlp[-1]
        add("all_gather", _ag(B * d * 4, world))
        add("reduce_scatter", _rs(B // world * d * 4, world))
    if cfg.arch == "mind":
        add("all_gather", _ag(world * 4, world))
        add("reduce_scatter", _rs(4, world))
    return out


def _xla_differences(arch_id: str, shape: str) -> float:
    """The bytes by which the reference's compiled cell exceeds the port's,
    named.  (a) The reference's ``layers.constrain`` is a no-op outside a
    mesh context, and ``jax.jit`` with ``in_shardings`` sets none: its
    ``dense_shard`` does not split the batch over model, so each model rank
    runs the dense stage on its data rank's whole slice, and the dense
    leaves' gradients and the loss are summed over data only, where the
    port's (B / 8 rows a rank, as the reference's code asks) are summed over
    the mesh.  (b) A ranking arch's retrieval: ``jax.lax.top_k`` of the
    scores split over data gathers every score over data, where the port
    gathers each rank's top k values and positions over the mesh.  (c)
    mind's train step all-reduces the item table's two scatter gradients
    (history and target) apart, and rolls the BPR negative by three
    collective-permutes of one score, where the port adds the two before
    its one all-reduce and all-gathers the ranks' last scores (and
    reduce-scatters their cotangent).  (d) Two-tower's in-batch logits:
    XLA lays the item vectors' transpose out by a collective-permute of a
    [d, B / 4] block and an all-gather over model into [d, B], and its
    transpose all-reduces the [B_l, d] cotangent over data and over model
    and permutes it once, where the port all-gathers [B, d] over the mesh
    and reduce-scatters its cotangent."""
    cfg = ranks.capped_config(arch_id, ROW_CAP)
    dp, tp = MESH
    world = dp * tp
    if _kind(shape) == "retrieval":
        if cfg.arch in ("two_tower", "mind"):
            return 0.0
        return _ag(N_CANDIDATES * 4, dp) - 2 * _ag(
            min(RC.RETRIEVAL_K, N_CANDIDATES // world) * world * 4, world)
    if _kind(shape) != "train":
        return 0.0
    dense, tables = _leaf_bytes(arch_id)
    B = BATCHES[shape]
    extra = _ar(dense + 4, dp) - _ar(dense + 4, world)
    if cfg.arch == "mind":
        extra += _ar(tables["emb"], dp) + 3 * 4 - _ag(world * 4, world) - _rs(4, world)
    if cfg.arch == "two_tower":
        d, bl = cfg.mlp[-1], B // dp
        extra += (d * B // tp * 4 + _ag(d * B * 4, tp) + _ar(bl * d * 4, dp) + _ar(bl * d * 4, tp)
                  + bl * d * 4) - _ag(B * d * 4, world) - _rs(B // world * d * 4, world)
    return extra


@pytest.mark.parametrize("arch_id, shape", CELLS)
def test_cell_bytes_follow_the_ring_model(runs, arch_id, shape):
    """Every rank counts the formula's bytes; the reference's compiled cell
    moves them too, but for the named differences."""
    ref, counted, _, _ = runs
    key = f"{arch_id}|{shape}"
    want = _ring_bytes(arch_id, shape)
    for c in counted:
        assert c["bytes"][key] == pytest.approx(want, rel=1e-12, abs=1e-6)
    assert sum(want.values()) + _xla_differences(arch_id, shape) == pytest.approx(
        float(ref[f"hlo_bytes|{key}"]), rel=1e-12, abs=1e-6)


@pytest.mark.parametrize("arch_id, shape", CELLS)
def test_dry_trace_counts_what_the_ranks_counted(runs, monkeypatch, arch_id, shape):
    """Rank 0's part of the cell traced on meta under a ``DryMesh`` of the
    test's mesh (``launch.hlo_analysis.Trace``, as ``launch.dryrun`` traces
    a cell): the collective bytes and calls of each op are those every rank
    counted on the real mesh."""
    from repro_torch.launch.hlo_analysis import Trace

    _, counted, _, _ = runs
    for name, batch in BATCHES.items():
        monkeypatch.setitem(RC.RECSYS_SHAPES[name], "batch", batch)
    monkeypatch.setitem(RC.RECSYS_SHAPES["retrieval_cand"], "n_candidates", N_CANDIDATES)
    cfg = ranks.capped_config(arch_id, ROW_CAP)
    cell = RC._build(shape, M.DryMesh(MESH, ("data", "model")), False, cfg_fn=lambda: cfg)
    args = cell.blocks(cell.args, M.DryMesh(MESH, ("data", "model")))
    with Trace() as tr:
        cell.step_fn(*args)
    key = f"{arch_id}|{shape}"
    for c in counted:
        assert tr.collective_bytes() == c["bytes"][key]
        assert {op: v["calls"] for op, v in tr.collectives.items()} == c["calls"][key]



@pytest.mark.parametrize("arch_id, shape", CELLS)
def test_chip_smoke_ring_model_is_the_tests(arch_id, shape):
    """``chip_smoke.recsys_cell_ring_bytes`` (phase 5g2's bytes check on the
    card) gives this file's formula, which the ranks' counts meet, at this
    mesh and these sizes."""
    import chip_smoke

    cfg = ranks.capped_config(arch_id, ROW_CAP)
    n = N_CANDIDATES if _kind(shape) == "retrieval" else BATCHES[shape]
    assert chip_smoke.recsys_cell_ring_bytes(cfg, _kind(shape), n, MESH,
                                             queries=TT_QUERIES) == _ring_bytes(arch_id, shape)
