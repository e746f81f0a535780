"""repro_torch's sharded embedding path against the JAX package's, on the CPU.

The reference runs once, in a subprocess with 8 forced host devices
(``tests/_jax_sharded_reference.py``, the pattern of test_sharded_paths.py),
under its (data 2, model 4) mesh; the port runs at the same time on 8 gloo
ranks of the same mesh (``tests/_torch_sharded_ranks.py`` through
``launch.mesh.spawn``).  Both read the same seeded numpy inputs; params
cross to the port with ``params_from_numpy``'s conversion.  Each rank's
blocks are held against the same blocks of the reference's whole outputs.
Besides the lookup and the DLRM, the same spawn runs the other recsys
archs (wide_deep in mesh2d with a separate and a fused wide table; deepfm,
two_tower and mind forward, loss, gradients and one step in the paper
layout), both retrievals under the mesh, and the LM's sequence-sharded
decode: a tiny MoE transformer with the dense residual (6 heads padded to 8
and vocab 128 to 512 at tp 4), 4 decode steps by ``transformer.decode_step``
under the mesh at B = 4 (batch over data, positions over model) and in the
long_500k layout at B = 1 (positions over both axes), across a shard
boundary and with empty shards, with the params in the serving cell's
layout (heads, FFN columns and experts over model; in the ``_fsdp`` cases
the weight rows over data too, the reference's params placed so), and
``layers.sharded_vocab_embed``; and
the LM's tensor-, sequence- and FSDP-parallel paths
(``tests/_jax_sharded_reference.py ... lm_tp``, a second subprocess):
``forward``, ``prefill`` then ``caches_for_decode`` and 4 ``decode_step``s,
and ``make_train_step`` (fsdp, 2 microbatches; the gradients, an Adam step
and an Adafactor train cell's step) for a dense config with seq_shard
(also on the (2, 2, 2) pod mesh), 6 heads padded to 8 over 2 unsharded KV
heads with QKV bias, and an MoE config with the dense residual, each
rank's blocks and bytes against the reference's and the ring model's.
The GNN rides in the same spawn: the edge-sharded ``forward_full_graph``
and ``make_train_step_full`` (the gradients, then Adam), the partitioned
forward in f32 and bf16 comm, and the minibatch and molecule cells' loss,
gradients and step, each against the reference's mesh run and its
one-device run.

Tolerances: f32 rtol 1e-5, atol 1e-6 (other summation orders: the
collective's against XLA's); ``comm_dtype=bf16`` rtol and atol 2e-2, the
reference's own for bf16 partials.  Collective bytes are exact: each
rank's ``comm.bytes.*`` counters equal the ring model's formula for the
case's shapes, and equal the collective bytes ``analyze`` reads from the
reference's compiled HLO.  XLA combines the two chunks' all-reduces of
``num_chunks=2`` into one tuple all-reduce (same bytes, one call against the
port's two), and its CPU backend promotes a bf16 collective to f32 (the
HLO moves twice the bytes of the port's bf16 payload).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.embedding import DisaggEmbedding
from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.launch import mesh as M
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.optim import sharding_rules as SR
from repro_torch.utils import keystr, tree_flatten_with_path, tree_map, tree_unflatten

import _torch_sharded_ranks as ranks

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
STEP_TOL = (1e-4, 1e-6)  # params and state after an Adam step, as test_torch_gnn.py's
BF16_TOL = 2e-2
REF_TIMEOUT_S = 240
SPAWN_TIMEOUT_S = 240
MESH = (2, 4)  # (data, model)
B, DIM = 16, 16
EMB_SPECS = [("a", 1000, 4, "sum"), ("b", 500, 2, "mean"), ("c", 64, 1, "sum")]
DLRM_SPECS = [("big", 4000, 4, "sum"), ("mid", 1000, 1, "sum"), ("small", 64, 1, "sum")]


def _case(mode, num_chunks=1, cache=None, replicated=(), comm=None):
    ns = 8 if mode == "mesh2d" else 4
    return dict(mode=mode, num_chunks=num_chunks, cache=cache, replicated=list(replicated),
                comm=comm, num_shards=ns,
                params=f"emb|{ns}|{'rep' if replicated else 'plain'}")


LOOKUP_CASES = {
    "baseline": _case("baseline"),
    "hierarchical": _case("hierarchical"),
    "hierarchical_chunks2": _case("hierarchical", num_chunks=2),
    "hierarchical_flat_cache": _case("hierarchical", cache="flat"),
    "hierarchical_hash_cache": _case("hierarchical", cache="hash"),
    "baseline_hash_cache": _case("baseline", cache="hash"),
    "hierarchical_replicated": _case("hierarchical", replicated=(2,)),
    "hierarchical_bf16": _case("hierarchical", comm="bf16"),
    "mesh2d": _case("mesh2d"),
    "mesh2d_bf16": _case("mesh2d", comm="bf16"),
}
GRAD_MODES = ["baseline", "hierarchical", "mesh2d"]
# a (pod 2, data 2, model 2) mesh: two batch axes
POD_MESH = {"pod": 2, "data": 2, "model": 2}
POD_CASES = {"hierarchical": dict(_case("hierarchical"), num_shards=2, params="emb|2|plain"),
             "mesh2d": _case("mesh2d")}
DLRM_MODES = ["baseline", "hierarchical", "mesh2d"]
TRAIN_MODES = ["hierarchical", "mesh2d"]
# the other recsys archs: wide_deep and deepfm on the DLRM's tables and batch
TT_SPECS = [("u", 1000, 1, "sum"), ("ug", 64, 1, "sum"), ("i", 1000, 1, "sum"),
            ("ic", 32, 1, "sum")]
ARCH_SPECS = {
    "wide_deep": dict(arch="wide_deep", tables=DLRM_SPECS, n_dense=13, mlp=[32, 16],
                      use_wide=True),
    "deepfm": dict(arch="deepfm", tables=DLRM_SPECS, n_dense=13, mlp=[32, 16]),
    "two_tower": dict(arch="two_tower", tables=TT_SPECS, user_tables=2, mlp=[32, 16]),
    "mind": dict(arch="mind", tables=[("item", 2000, 1, "sum")], hist_len=10, n_interests=3),
}
ARCH_CASES = {
    "wide_deep_mesh2d": dict(arch="wide_deep", mode="mesh2d", over={}),
    "wide_deep_fused_mesh2d": dict(arch="wide_deep", mode="mesh2d", over={"fuse_wide": True}),
    "deepfm": dict(arch="deepfm", mode="hierarchical", over={}),
    "two_tower": dict(arch="two_tower", mode="hierarchical", over={}),
    "mind": dict(arch="mind", mode="hierarchical", over={}),
}
ARCH_TRAIN = ["deepfm", "two_tower", "mind"]
RETRIEVALS = ["two_tower", "two_tower_split", "mind"]
N_CANDS, MIND_CANDS, TT_QUERIES = 256, 512, 8
# the LM's sharded decode: a tiny MoE config with the dense residual, f32
LM_CFG = dict(name="tiny-moe", n_layers=2, d_model=32, n_heads=6, n_kv_heads=2, d_ff=64,
              vocab=128, d_head=8, moe_dense_residual=True)
LM_MOE = dict(num_experts=8, top_k=2, d_ff=48, capacity_factor=1.25)
LM_CACHE, LM_POS, LM_STEPS = 32, 13, 4  # steps write positions 13-16
# name: (batch, batch axes, sequence axes, weight rows FSDP over data, the
# case whose caches and tokens it takes)
LM_DECODE_CASES = {
    "b4_model": (4, ["data"], ["model"], False, "b4_model"),
    "long_500k_b1": (1, [], ["data", "model"], False, "long_500k_b1"),
    "b4_model_fsdp": (4, ["data"], ["model"], True, "b4_model"),
    "long_500k_b1_fsdp": (1, [], ["data", "model"], True, "long_500k_b1"),
}
# the decode programs held against the compiled HLO take LM_CFG at head dim
# 16: their dry trace takes K7's meta route, whose f32 head dims start there
LM_HLO_D_HEAD = 16
EMBED_SHAPE = (16, 5)
# the LM's tensor-, sequence- and FSDP-parallel paths, f32 compute: (a) the
# reference's test_transformer_sharded_matches_single config (KV sharded,
# seq_shard), also on the pod mesh with two batch axes; (b) 6 heads padded
# to 8 over 2 KV heads (not sharded: each rank reads one), QKV bias, no
# seq_shard, no FSDP outside training; (c) the reference's
# test_moe_sharded_matches_reference config, at a capacity factor that drops
LM_TP_DENSE = dict(name="tp-dense", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, d_ff=128,
                   vocab=256, d_head=8, remat_groups=2, seq_shard=True)
LM_TP_CASES = {
    "dense": dict(cfg=LM_TP_DENSE, moe=None, mesh="main", batch_axes=["data"], adafactor=True),
    "padded": dict(cfg=dict(name="tp-padded", n_layers=2, d_model=32, n_heads=6, n_kv_heads=2,
                            d_ff=64, vocab=128, d_head=8, qkv_bias=True, fsdp=False),
                   moe=None, mesh="main", batch_axes=["data"], adafactor=False),
    "moe": dict(cfg=dict(name="tp-moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                         d_ff=64, vocab=128, d_head=8, remat_groups=2, moe_dense_residual=True),
                moe=dict(num_experts=8, top_k=2, d_ff=32, capacity_factor=1.0),
                mesh="main", batch_axes=["data"], adafactor=False),
    "dense_pod": dict(cfg=LM_TP_DENSE, moe=None, mesh="pod", batch_axes=["pod", "data"],
                      adafactor=False),
}
LM_TP_SHAPE, LM_TP_TRAIN_BATCH = (4, 16), 8  # forward/prefill [B, S]; the train batch
LM_TP_MAX_LEN, LM_TP_STEPS = 32, 4  # decode writes positions 16-19
# the GNN: a small GraphSAGE on a 64-node graph (edges split 8 ways), the
# partitioned layout's edges grouped by their destination's owner, the
# minibatch cell at these widths (one block of 4 targets at fanout (3, 2) a
# rank) and the molecule cell at its published shape
GNN_CFG = dict(name="t", n_layers=2, d_in=16, d_hidden=8, n_classes=5)
GNN_N, GNN_E = 64, 512
GNN_MINIBATCH = dict(batch_nodes=32, fanout=[3, 2], d_feat=16, n_classes=5)
GNN_CELLS = ["minibatch_lg", "molecule"]
META = dict(mesh=list(MESH), dim=DIM, emb_specs=EMB_SPECS, dlrm_specs=DLRM_SPECS, n_dense=13,
            bottom_mlp=[64, DIM], mlp=[64, 32], lookup_cases=LOOKUP_CASES,
            grad_modes=GRAD_MODES, pod_cases=POD_CASES, dlrm_modes=DLRM_MODES, train_modes=TRAIN_MODES,
            flat_slots=64, hash_slots=128, max_norm=0.05, arch_specs=ARCH_SPECS,
            arch_cases=ARCH_CASES, arch_forward=list(ARCH_CASES), arch_train=ARCH_TRAIN,
            retrieval_k=10, lm=LM_CFG, lm_moe=LM_MOE, lm_pos=LM_POS, lm_steps=LM_STEPS,
            lm_decode_cases=LM_DECODE_CASES, lm_hlo_d_head=LM_HLO_D_HEAD,
            lm_tp_cases=LM_TP_CASES,
            lm_tp_max_len=LM_TP_MAX_LEN,
            gnn=dict(cfg=GNN_CFG, minibatch=GNN_MINIBATCH))


def _inputs(rng) -> dict:
    """Seeded numpy inputs: the lookup batch (masked slots hold random ids),
    tables for each layout, hot ids, gathered ids and the tiny DLRM's params
    (test_system's shapes) and batch."""
    d = {"meta": np.array(json.dumps(META))}
    specs = ranks.specs_of(EMB_SPECS)
    idx = np.zeros((B, len(specs), 4), np.int32)
    msk = np.zeros((B, len(specs), 4), bool)
    for f, s in enumerate(specs):
        idx[:, f, :] = rng.integers(0, s.vocab, (B, 4))
        msk[:, f, :s.nnz] = np.arange(s.nnz)[None, :] < rng.integers(1, s.nnz + 1, (B, 1))
    d["idx"], d["mask"] = idx, msk
    for ns in (2, 4, 8):
        for rep in ((), (2,)):
            emb = DisaggEmbedding(specs, dim=DIM, num_shards=ns, replicated_fields=rep)
            for key, t in emb.abstract_params().items():
                d[f"emb|{ns}|{'rep' if rep else 'plain'}|{key}"] = (
                    rng.standard_normal(tuple(t.shape)) * 0.1).astype(np.float32)
    fused = DisaggEmbedding(specs, dim=DIM, num_shards=4)._fused_rows(
        DisaggEmbedding(specs, dim=DIM, num_shards=4).sharded, torch.from_numpy(idx)).numpy()
    d["hot"] = rng.permutation(np.unique(fused[msk]))[:96].astype(np.int32)
    # ids in the table's padding rows (1564-1567), then past its 1568 rows
    d["row_ids"] = np.concatenate([rng.integers(0, 1564, 20),
                                   [1564, 1567, 1568, 5000, np.iinfo(np.int32).max]]
                                  ).astype(np.int32)
    cfg = ranks.dlrm_cfg(META, "hierarchical")
    for ns in (4, 8):
        for path, t in tree_flatten_with_path(R.abstract_params(cfg, ns)):
            scale = 0.1 if path[0] == "emb" else 1.0 / np.sqrt(t.shape[0])
            d["|".join([f"dlrm{ns}", *path])] = (
                rng.standard_normal(tuple(t.shape)) * scale).astype(np.float32)
    b = syn.recsys_batch(rng, cfg.tables, B, n_dense=13)
    for k in ("indices", "mask", "dense", "labels"):
        d[f"dlrm_batch|{k}"] = b[k]
        for arch in ("wide_deep", "deepfm"):
            d[f"arch_batch|{arch}|{k}"] = b[k]
    _arch_inputs(rng, d)
    _lm_inputs(rng, d)
    _lm_tp_inputs(rng, d)
    _gnn_inputs(rng, d)
    return d


def _lm_inputs(rng, d: dict) -> None:
    """The tiny MoE LM's params in the mesh's geometry (numpy normals at the
    reference's scales, norms near 1), each decode case's caches (random
    rows throughout: the reference multiplies the rows past cache_len by 0,
    so they must be finite) and tokens, and the embedding table and tokens
    of the sharded lookup."""
    cfg = ranks.lm_cfg(META)
    shapes = T.init_params(cfg, device="cpu", mesh=M.AbstractMesh(MESH, ("data", "model")))
    for path, t in tree_flatten_with_path(shapes):
        if path[-1] in ("ln1", "ln2", "final_ln"):
            arr = 1.0 + 0.1 * rng.standard_normal(tuple(t.shape))
        else:
            fan_in = 1.0 if path == ("embed",) else t.shape[-2]
            arr = rng.standard_normal(tuple(t.shape)) / np.sqrt(fan_in)
        d["|".join(["lm", *path])] = np.asarray(arr, np.float32)
    for name, (b, _, _, _, inputs) in LM_DECODE_CASES.items():
        if inputs != name:
            continue
        shape = (cfg.n_layers, b, LM_CACHE, cfg.n_kv_heads, cfg.d_head)
        for kv in ("k", "v"):
            d[f"lm_cache|{name}|{kv}"] = rng.standard_normal(shape).astype(np.float32)
        d[f"lm_tokens|{name}"] = rng.integers(0, cfg.vocab, (LM_STEPS, b)).astype(np.int32)
    d["embed_table"] = rng.standard_normal((cfg.padded_vocab(M.AbstractMesh(
        MESH, ("data", "model"))), DIM)).astype(np.float32)
    d["embed_tokens"] = rng.integers(0, cfg.vocab, EMBED_SHAPE).astype(np.int32)


def _lm_tp_mesh(case: dict) -> M.AbstractMesh:
    if case["mesh"] == "pod":
        return M.AbstractMesh(tuple(POD_MESH.values()), tuple(POD_MESH))
    return M.AbstractMesh(MESH, ("data", "model"))


def _lm_tp_inputs(rng, d: dict) -> None:
    """Each LM case's params in its mesh's geometry (numpy normals over
    sqrt(fan in), norms near 1, biases and the router random), rounded to
    values bf16 holds exactly (the prefill cell's bf16 params are the same
    numbers), its prompts, decode tokens and a train batch whose labels are
    a fifth masked."""
    for name, case in LM_TP_CASES.items():
        cfg = ranks.lm_tp_cfg(case)
        shapes = T.init_params(cfg, device="meta", mesh=_lm_tp_mesh(case))
        for path, t in tree_flatten_with_path(shapes):
            shape = tuple(t.shape)
            if path[-1] in ("ln1", "ln2", "final_ln"):
                arr = 1.0 + 0.1 * rng.standard_normal(shape)
            elif path[-1] in ("bq", "bk", "bv"):
                arr = 0.1 * rng.standard_normal(shape)
            else:
                fan_in = {("embed",): 1.0, ("head",): cfg.d_model}.get(path, shape[-2])
                arr = rng.standard_normal(shape) / np.sqrt(fan_in)
            arr = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16).float().numpy()
            d["|".join([f"lmtp|{name}", *path])] = arr
        b, s = LM_TP_SHAPE
        d[f"lmtp_tokens|{name}"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        d[f"lmtp_decode_tokens|{name}"] = rng.integers(0, cfg.vocab, (LM_TP_STEPS, b)).astype(
            np.int32)
        d[f"lmtp_train|{name}|tokens"] = rng.integers(0, cfg.vocab, (LM_TP_TRAIN_BATCH, s)).astype(
            np.int32)
        labels = rng.integers(0, cfg.vocab, (LM_TP_TRAIN_BATCH, s))
        d[f"lmtp_train|{name}|labels"] = np.where(rng.random(labels.shape) < 0.2, -1,
                                                  labels).astype(np.int32)


def _gnn_params(rng, d: dict, prefix: str, cfg: G.GNNConfig) -> None:
    """Weights uniform in +-1/sqrt(fan in), biases N(0, 0.1^2)."""
    for path, t in tree_flatten_with_path(G.abstract_params(cfg)):
        shape = tuple(t.shape)
        if path[-1] == "b":
            arr = 0.1 * rng.standard_normal(shape)
        else:
            arr = rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        key = "out" if path == ("out",) else f"l{path[1]}|{path[2]}"
        d[f"{prefix}|{key}"] = arr.astype(np.float32)


def _gnn_inputs(rng, d: dict) -> None:
    """The GNN's params, its full graph (power-law destinations, a tenth of
    the edges masked), the partitioned layout's edges (each rank's block
    holds the edges whose destination it owns, padded with masked edges to
    its own first node, as tests/test_sharded_paths.py builds them), and
    the two cells' params and batches."""
    from repro_torch.configs import graphsage_reddit as GR
    from repro_torch.data import graph_sampler as GS

    cfg = G.GNNConfig(**GNN_CFG)
    _gnn_params(rng, d, "gnn_p", cfg)
    g = syn.random_graph(rng, GNN_N, GNN_E, cfg.d_in, cfg.n_classes)
    g["edge_mask"] = rng.random(GNN_E) > 0.1
    for k, v in g.items():
        d[f"gnn_full|{k}"] = v
    n_dev, n_loc = MESH[0] * MESH[1], GNN_N // (MESH[0] * MESH[1])
    live = g["edges"][g["edge_mask"]]
    owner = live[:, 1] // n_loc
    cap = max(int(np.sum(owner == s)) for s in range(n_dev))
    ep = np.zeros((n_dev * cap, 2), np.int32)
    mp = np.zeros((n_dev * cap,), bool)
    for s in range(n_dev):
        rows = live[owner == s]
        ep[s * cap:s * cap + len(rows)] = rows
        ep[s * cap + len(rows):(s + 1) * cap, 1] = s * n_loc
        mp[s * cap:s * cap + len(rows)] = True
    d["gnn_part|edges"], d["gnn_part|edge_mask"] = ep, mp
    mb = {**GR.SHAPES["minibatch_lg"], **GNN_MINIBATCH}
    _gnn_params(rng, d, "gnn_cellp|minibatch_lg", GR._cfg(mb))
    n_graph = 200
    gg = syn.random_graph(rng, n_graph, 1600, mb["d_feat"], mb["n_classes"])
    csr = GS.edges_to_csr(gg["edges"], n_graph, gg["feats"], gg["labels"])
    tgt = mb["batch_nodes"] // n_dev
    blks = [GS.sample_block(csr, rng, rng.choice(n_graph, tgt, replace=False),
                            tuple(mb["fanout"])) for _ in range(n_dev)]
    cell = {"feats": [b.feats for b in blks], "edges1": [b.hop_edges[0] for b in blks],
            "mask1": [b.hop_masks[0] for b in blks], "edges2": [b.hop_edges[1] for b in blks],
            "mask2": [b.hop_masks[1] for b in blks], "labels": [b.labels for b in blks]}
    for k, v in cell.items():
        d[f"gnn_cell|minibatch_lg|{k}"] = np.stack(v)
    mol = GR.SHAPES["molecule"]
    _gnn_params(rng, d, "gnn_cellp|molecule", GR._cfg(mol))
    gb, n, e = mol["batch"], mol["n_nodes"], mol["n_edges"]
    d["gnn_cell|molecule|feats"] = rng.standard_normal((gb, n, mol["d_feat"])).astype(np.float32)
    d["gnn_cell|molecule|edges"] = rng.integers(0, n, (gb, e, 2)).astype(np.int32)
    d["gnn_cell|molecule|edge_mask"] = rng.random((gb, e)) < 0.9
    d["gnn_cell|molecule|labels"] = rng.standard_normal(gb).astype(np.float32)


def _arch_inputs(rng, d: dict) -> None:
    """Params of every arch case (tables N(0, 0.1^2), mind's N(0, 1) so its
    scores and gradients are far from rounding; two_tower's temperature
    the reference's 0.05), two_tower's and mind's batches (two_tower's with
    ``log_q``) and the retrieval inputs."""
    for name in ARCH_CASES:
        cfg = ranks.arch_cfg(META, name)
        ns = 8 if cfg.mode == "mesh2d" else 4
        for path, t in tree_flatten_with_path(R.abstract_params(cfg, ns)):
            if path == ("temp",):
                arr = np.float32(0.05)
            elif path[0] in ("emb", "wide"):
                arr = rng.standard_normal(tuple(t.shape)) * (1.0 if cfg.arch == "mind" else 0.1)
            else:
                arr = rng.standard_normal(tuple(t.shape)) / np.sqrt(t.shape[0])
            d["|".join([f"arch|{name}", *map(str, path)])] = np.asarray(arr, np.float32)
    tt = ranks.specs_of(TT_SPECS)
    b = syn.recsys_batch(rng, tt, B)
    b["log_q"] = np.log(rng.uniform(0.01, 1.0, B)).astype(np.float32)
    for k in ("indices", "mask", "labels", "log_q"):
        d[f"arch_batch|two_tower|{k}"] = b[k]
    mind = ARCH_SPECS["mind"]
    for k, v in syn.mind_batch(rng, mind["tables"][0][1], B, mind["hist_len"]).items():
        d[f"arch_batch|mind|{k}"] = v
    q = syn.recsys_batch(rng, tt, TT_QUERIES)
    d["tt_query|indices"], d["tt_query|mask"] = q["indices"], q["mask"]
    d["cands"] = rng.standard_normal((N_CANDS, ARCH_SPECS["two_tower"]["mlp"][-1])).astype(
        np.float32)
    m = syn.mind_batch(rng, mind["tables"][0][1], 1, mind["hist_len"])
    d["mind_query|hist"], d["mind_query|hist_mask"] = m["hist"], m["hist_mask"]
    d["mind_query|cand_ids"] = rng.permutation(mind["tables"][0][1])[:MIND_CANDS].astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, the 8 ranks' results): the reference's subprocess
    and the port's ranks run at the same time on the same inputs."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **_inputs(np.random.default_rng(0)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = str(ROOT / "tests" / "_jax_sharded_reference.py")
    refs = {part: subprocess.Popen([sys.executable, script, str(inputs), str(tmp / f"{part}.npz"),
                                    part], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
            for part in ("main", "lm_tp")}
    try:
        port = M.spawn(ranks.run, MESH[0] * MESH[1], (str(inputs),), timeout=SPAWN_TIMEOUT_S)
        errs = {part: ref.communicate(timeout=REF_TIMEOUT_S)[1] for part, ref in refs.items()}
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    for part, ref in refs.items():
        assert ref.returncode == 0, f"{part}: {errs[part][-4000:]}"
    return {**dict(np.load(tmp / "main.npz")), **dict(np.load(tmp / "lm_tp.npz"))}, port


class _Coords:
    """A rank's place on the mesh, for ``M.block_slices`` on numpy arrays."""

    def __init__(self, coords: dict, shape: dict):
        self.coords, self.shape = coords, shape

    def axis_size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


def _block(arr: np.ndarray, spec: P, coords: dict,
           shape: dict = dict(zip(("data", "model"), MESH))) -> np.ndarray:
    return arr[M.block_slices(arr.shape, spec, _Coords(coords, shape))]


def _close(got, want, tol=(RTOL, ATOL)):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol[0], atol=tol[1])


def _tol(case: dict):
    return (BF16_TOL, BF16_TOL) if case["comm"] == "bf16" else (RTOL, ATOL)


def _out_spec(mode: str) -> P:
    return P(("data", "model")) if mode == "mesh2d" else P("data")


def _table_spec(mode: str) -> P:
    return P(("data", "model")) if mode == "mesh2d" else P("model")


def _ring_bytes(case: dict) -> dict:
    """The ring model's per-device bytes of one lookup, from the shapes."""
    F = len(EMB_SPECS) - len(case["replicated"])
    b_local, g_model = B // MESH[0], MESH[1]
    item = 2 if case["comm"] == "bf16" else 4
    if case["mode"] == "mesh2d":  # idx + mask all-gathers, then RS over data, model
        return {"all_gather": (B * 3 * 4 * 4 + B * 3 * 4) * (MESH[0] - 1) / MESH[0],
                "reduce_scatter": (B // MESH[0] * F * DIM * item) * (MESH[0] - 1)
                + (B // (MESH[0] * MESH[1]) * F * DIM * item) * (MESH[1] - 1)}
    payload = b_local * F * DIM * item * (4 if case["mode"] == "baseline" else 1)
    return {"all_reduce": 2 * payload * (g_model - 1) / g_model}


@pytest.mark.parametrize("name", sorted(LOOKUP_CASES))
def test_lookup_matches_reference(runs, name):
    ref, port = runs
    case = LOOKUP_CASES[name]
    for r in port:
        got = r["outputs"][f"lookup|{name}"]
        want = _block(ref[f"lookup|{name}"], _out_spec(case["mode"]), r["coords"])
        assert got.shape == want.shape and got.dtype == np.float32
        _close(got, want, _tol(case))


@pytest.mark.parametrize("name", sorted(LOOKUP_CASES))
def test_lookup_bytes_follow_the_ring_model(runs, name):
    """Every rank counts the formula's bytes, which are the bytes of the
    reference's compiled collectives."""
    ref, port = runs
    case = LOOKUP_CASES[name]
    want = _ring_bytes(case)
    for r in port:
        assert r["bytes"][name] == want
    # XLA's CPU backend runs a bf16 collective in f32: its HLO moves f32 bytes
    hlo = _ring_bytes(dict(case, comm=None)) if case["comm"] == "bf16" else want
    assert sum(hlo.values()) == float(ref[f"hlo_bytes|{name}"])
    calls = {k.split("|")[2]: int(v) for k, v in ref.items()
             if k.startswith(f"hlo_calls|{name}|")}
    assert set(calls) == {op.replace("_", "-") for op in want}
    if name == "hierarchical_chunks2":  # XLA merged the chunks' all-reduces
        assert calls == {"all-reduce": 1}


def test_baseline_moves_nnz_times_the_hierarchical_bytes(runs):
    _, port = runs
    nnz = max(s[2] for s in EMB_SPECS)
    for r in port:
        assert r["bytes"]["baseline"]["all_reduce"] == nnz * r["bytes"]["hierarchical"][
            "all_reduce"]


@pytest.mark.parametrize("which", ["lookup_rows", "gather_rows"])
def test_lookup_rows_and_gather_rows(runs, which):
    ref, port = runs
    spec = P("data") if which == "lookup_rows" else P()
    for r in port:
        _close(r["outputs"][which], _block(ref[which], spec, r["coords"]))
        want = float(ref[f"hlo_bytes|{which}"])
        assert sum(r["bytes"][which].values()) == want
        assert list(r["bytes"][which]) == ["all_reduce"]
    if which == "gather_rows":  # ids past the table give zero rows
        assert np.all(ref[which][-3:] == 0) and np.all(ref[which][-5:-3] != 0)


def test_chunked_lookup_and_cache_partition_spec(runs):
    """``lookup_engine.chunked_lookup`` at 2 chunks against the reference's
    (the bytes of ``num_chunks=2``), and ``hotcache.table.cache_partition_spec``
    against the reference's: the cache replicated on every rank."""
    ref, port = runs
    for r in port:
        _close(r["outputs"]["chunked_lookup"], _block(ref["chunked_lookup"], P("data"),
                                                      r["coords"]))
        assert r["bytes"]["chunked_lookup"] == _ring_bytes(LOOKUP_CASES["hierarchical_chunks2"])
        assert r["cache_partition_spec"] == json.loads(str(ref["cache_partition_spec"]))
    assert port[0]["cache_partition_spec"] == {"keys": [None], "rows": [None, None],
                                               "freq": [None]}


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_lookup_gradient_matches_jax_grad(runs, mode):
    """The table's gradient of the lookup's sum: no factor of any axis size."""
    ref, port = runs
    for r in port:
        _close(r["outputs"][f"grad|{mode}"],
               _block(ref[f"grad|{mode}"], _table_spec(mode), r["coords"]))
    # forward collectives, their transposes, and the data-axis gradient sum
    fwd = _ring_bytes(LOOKUP_CASES[mode])
    got = port[0]["bytes"][f"grad|{mode}"]
    if mode == "mesh2d":  # no gradient sum: every row exists once
        assert got == {"all_gather": fwd["all_gather"] + _mesh2d_backward_gather(),
                       "reduce_scatter": fwd["reduce_scatter"]}
    else:
        rows = ref[f"grad|{mode}"].shape[0] // MESH[1]
        table_bytes = 2 * rows * DIM * 4 * (MESH[0] - 1) / MESH[0]
        assert got == {"all_reduce": 2 * fwd["all_reduce"] + table_bytes}


def _mesh2d_backward_gather() -> float:
    """The all-gathers that transpose mesh2d's reduce-scatters: over model
    into [B/data, F, D], then over data into [B, F, D]."""
    F = len(EMB_SPECS)
    return (B // MESH[0] * F * DIM * 4) * (MESH[1] - 1) / MESH[1] + (
        B * F * DIM * 4) * (MESH[0] - 1) / MESH[0]


@pytest.mark.parametrize("name", sorted(POD_CASES))
def test_two_batch_axes_match_reference(runs, name):
    """Under (pod 2, data 2, model 2) with batch axes (pod, data): mesh2d
    gathers the indices inner axis first and scatters outer axis first, so
    a wrong order would permute rows; each rank's rows, its table
    gradient's rows and its bytes against the reference's."""
    ref, port = runs
    mode = POD_CASES[name]["mode"]
    batch = ("pod", "data") + (("model",) if mode == "mesh2d" else ())
    table = ("pod", "data", "model") if mode == "mesh2d" else ("model",)
    for r in port:
        _close(r["outputs"][f"pod_lookup|{name}"],
               _block(ref[f"pod_lookup|{name}"], P(batch), r["coords3"], POD_MESH))
        _close(r["outputs"][f"pod_grad|{name}"],
               _block(ref[f"pod_grad|{name}"], P(table), r["coords3"], POD_MESH))
        assert sum(r["bytes"][f"pod|{name}"].values()) == float(ref[f"hlo_bytes|pod|{name}"])


@pytest.mark.parametrize("mode", DLRM_MODES)
def test_forward_matches_reference(runs, mode):
    ref, port = runs
    want = ref[f"forward|{mode}"]
    for r in port:
        _close(r["outputs"][f"forward|{mode}"], _block(want, P(("data", "model")), r["coords"]))
        _close(r["outputs"][f"forward_gathered|{mode}"], want)


def _param_spec_of(mode: str) -> dict:
    cfg = ranks.dlrm_cfg(META, mode)
    ns = 8 if mode == "mesh2d" else 4
    return {keystr(p): s for p, s in tree_flatten_with_path(
        R.param_specs(cfg, ns, ("data",)), lambda x: isinstance(x, P))}


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_loss_and_clipped_grads_match_reference(runs, mode):
    """``loss_and_grads(mesh=...)`` and ``clip_by_global_norm(mesh=...)``
    against ``jax.value_and_grad`` under the reference's mesh and its clip:
    the norm counts each table shard once and each replicated leaf once."""
    ref, port = runs
    spec_of = _param_spec_of(mode)
    for r in port:
        _close(r["outputs"][f"loss|{mode}"], ref[f"loss|{mode}"])
        _close(r["outputs"][f"norm|{mode}"], ref[f"norm|{mode}"])
        for key, spec in spec_of.items():
            _close(r["outputs"][f"clipped|{mode}|{key}"],
                   _block(ref[f"clipped|{mode}|{key}"], spec, r["coords"]))
    assert float(ref[f"norm|{mode}"]) > META["max_norm"]  # the clip bites


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_train_step_matches_reference(runs, mode):
    """One ``make_train_step(mesh=...)`` step: loss, params, and the
    optimizer state laid out by ``sharding_rules.composite_state_specs``."""
    ref, port = runs
    cfg = ranks.dlrm_cfg(META, mode)
    ns = 8 if mode == "mesh2d" else 4
    pspecs = R.param_specs(cfg, ns, ("data",))
    state_specs = SR.composite_state_specs([("emb", "rowwise"), (".*", "adam")], pspecs,
                                           R.abstract_params(cfg, ns))
    state_spec_of = {keystr(p): s for p, s in tree_flatten_with_path(
        state_specs, lambda x: isinstance(x, P))}
    for r in port:
        _close(r["outputs"][f"step_loss|{mode}"], ref[f"step_loss|{mode}"])
        for key, spec in _param_spec_of(mode).items():
            _close(r["outputs"][f"step_params|{mode}|{key}"],
                   _block(ref[f"step_params|{mode}|{key}"], spec, r["coords"]))
        keys = [k[len(f"step_state|{mode}|"):] for k in r["outputs"]
                if k.startswith(f"step_state|{mode}|")]
        assert sorted(keys) == sorted(state_spec_of)
        for key in keys:
            _close(r["outputs"][f"step_state|{mode}|{key}"],
                   _block(ref[f"step_state|{mode}|{key}"], state_spec_of[key], r["coords"]))


@pytest.mark.parametrize("name", list(ARCH_CASES))
def test_arch_forward_matches_reference(runs, name):
    """wide_deep in mesh2d with a separate and a fused wide table; deepfm,
    two_tower and mind in the paper layout: each rank's slice of the scores."""
    ref, port = runs
    for r in port:
        _close(r["outputs"][f"arch_forward|{name}"],
               _block(ref[f"arch_forward|{name}"], P(("data", "model")), r["coords"]))


def _arch_spec_of(name: str) -> dict:
    cfg = ranks.arch_cfg(META, name)
    return {keystr(p): s for p, s in tree_flatten_with_path(
        R.param_specs(cfg, 4, ("data",)), lambda x: isinstance(x, P))}


@pytest.mark.parametrize("name", ARCH_TRAIN)
def test_arch_train_step_matches_reference(runs, name):
    """deepfm (its ``wide`` table laid out and reduced as a table), two_tower
    (in-batch logits over the global batch, ``log_q`` gathered) and mind (the
    BPR negative rolled across ranks): the loss, every gradient block and
    one step's params and optimizer state against the reference's GSPMD."""
    ref, port = runs
    spec_of = _arch_spec_of(name)
    if name == "deepfm":
        assert spec_of["['wide']['table']"] == P("model", None)
    cfg = ranks.arch_cfg(META, name)
    state_specs = SR.composite_state_specs([("emb|wide", "rowwise"), (".*", "adam")],
                                           R.param_specs(cfg, 4, ("data",)),
                                           R.abstract_params(cfg, 4))
    state_spec_of = {keystr(p): s for p, s in tree_flatten_with_path(
        state_specs, lambda x: isinstance(x, P))}
    for r in port:
        out = r["outputs"]
        _close(out[f"arch_loss|{name}"], ref[f"arch_loss|{name}"])
        _close(out[f"arch_step_loss|{name}"], ref[f"arch_step_loss|{name}"])
        for key, spec in spec_of.items():
            _close(out[f"arch_grads|{name}|{key}"],
                   _block(ref[f"arch_grads|{name}|{key}"], spec, r["coords"]))
            _close(out[f"arch_step_params|{name}|{key}"],
                   _block(ref[f"arch_step_params|{name}|{key}"], spec, r["coords"]))
        keys = [k[len(f"arch_step_state|{name}|"):] for k in out
                if k.startswith(f"arch_step_state|{name}|")]
        assert sorted(keys) == sorted(state_spec_of)
        for key in keys:
            _close(out[f"arch_step_state|{name}|{key}"],
                   _block(ref[f"arch_step_state|{name}|{key}"], state_spec_of[key],
                          r["coords"]))


@pytest.mark.parametrize("name", RETRIEVALS)
def test_retrieval_under_the_mesh_matches_reference(runs, name):
    """``retrieval_topk`` (candidates over every axis; queries whole, then
    split over data) and ``mind_retrieval`` (candidates over data): every
    rank holds the global top-k, values allclose and indices equal on
    tie-free scores."""
    ref, port = runs
    want_v, want_i = ref[f"retrieval|{name}|values"], ref[f"retrieval|{name}|indices"]
    assert want_v.shape[1] == META["retrieval_k"]
    assert len(np.unique(want_v)) == want_v.size
    for r in port:
        _close(r["outputs"][f"retrieval|{name}|values"], want_v)
        np.testing.assert_array_equal(r["outputs"][f"retrieval|{name}|indices"], want_i)


def _decode_ring_bytes(cfg, am, b: int, batch_axes, seq_axes, steps: int,
                       fsdp_axes=("data",)) -> dict:
    """One rank's bytes over ``steps`` of ``decode_step`` by the ring model,
    f32, the weight rows split over ``fsdp_axes`` under ``cfg.fsdp``.  The
    token embedding's all-reduce [B_l, D] over model.  Each layer: the
    all-gathers over model of the rank's query heads [B_l, Hp / tp, dh]
    and, where they divide tp, its KV heads; the max
    all-reduce of the row maxima [B_l, Hp] and the all-reduce of the
    scaled sums [B_l, Hp, dh + 1] over the sequence axes; the all-reduces
    over model of the ``wo`` and ``wd`` partials and of the experts'
    [B_l, D].  With FSDP over the batch every layer weight's model block
    is all-gathered over the FSDP axes; with FSDP and no batch axes the
    residual's model dim is split over them, its partial products (the two
    norms' sums of squares, q, k, v, the SwiGLU's two columns, the final
    norm's and the head's) are all-reduced there, and the experts take the
    whole normed state, gathered there, and their rows, gathered there."""
    ar = lambda n, g: 2 * n * (g - 1) / g  # noqa: E731
    ag = lambda n, g: n * (g - 1) / g  # noqa: E731
    tp, g_seq = am.shape["model"], am.axis_size(tuple(seq_axes))
    fsdp = am.axis_size(tuple(fsdp_axes)) if cfg.fsdp else 1
    partial = fsdp > 1 and not batch_axes
    bl = b // am.axis_size(tuple(batch_axes))
    D, dh, hp = cfg.d_model, cfg.d_head, cfg.padded_heads(am)
    kv = cfg.kv_sharded(am)
    hl, hkv_l, dm = hp // tp, cfg.n_kv_heads // (tp if kv else 1), D // (fsdp if partial else 1)
    out: dict = {}

    def add(op: str, v: float) -> None:
        out[op] = out.get(op, 0) + steps * v

    add("all_reduce", ar(bl * D * 4, tp))
    for _ in range(cfg.n_layers):
        add("all_gather", ag(bl * hp * dh * 4, tp) + (2 * ag(bl * cfg.n_kv_heads * dh * 4, tp)
                                                       if kv else 0))
        add("all_reduce_max", ar(bl * hp * 4, g_seq))
        add("all_reduce", ar(bl * hp * (dh + 1) * 4, g_seq) + ar(bl * dm * 4, tp))
        if cfg.dense_ffn():
            add("all_reduce", ar(bl * dm * 4, tp))
        if cfg.moe:
            add("all_reduce", ar(bl * D * 4, tp))
        experts = 3 * cfg.moe.num_experts // tp * D * cfg.moe.d_ff * 4 if cfg.moe else 0
        if fsdp > 1 and not partial:
            dense = 3 * D * cfg.d_ff // tp * 4 if cfg.dense_ffn() else 0
            add("all_gather", ag(2 * D * hl * dh * 4, fsdp) + 2 * ag(D * hkv_l * dh * 4, fsdp)
                + ag(dense, fsdp) + ag(experts, fsdp))
        if partial:
            add("all_reduce", 2 * ar(bl * 4, fsdp) + ar(bl * hl * dh * 4, fsdp)
                + 2 * ar(bl * hkv_l * dh * 4, fsdp))
            if cfg.dense_ffn():
                add("all_reduce", 2 * ar(bl * cfg.d_ff // tp * 4, fsdp))
            if cfg.moe:
                add("all_gather", ag(bl * D * 4, fsdp) + ag(experts, fsdp))
    if partial:
        add("all_reduce", ar(bl * 4, fsdp) + ar(bl * cfg.padded_vocab(am) // tp * 4, fsdp))
    return out


def _lm_case_cfg(name: str, hlo: bool = False):
    """Decode case ``name``'s config; with ``hlo`` at LM_HLO_D_HEAD."""
    cfg = ranks.lm_cfg(META, LM_DECODE_CASES[name][3])
    return dataclasses.replace(cfg, d_head=LM_HLO_D_HEAD) if hlo else cfg


def _lm_ring_bytes(name: str, hlo: bool = False) -> dict:
    b, batch_axes, seq_axes, _, _ = LM_DECODE_CASES[name]
    return _decode_ring_bytes(_lm_case_cfg(name, hlo), M.AbstractMesh(MESH, ("data", "model")),
                              b, batch_axes, seq_axes, LM_STEPS)


@pytest.mark.parametrize("name", list(LM_DECODE_CASES))
def test_lm_sharded_decode_matches_reference(runs, name):
    """``decode_step`` under the mesh against the reference's ``decode_step``
    under its mesh, both with the params in the serving cell's layout
    (``mesh_param_specs``: heads, FFN columns and experts over model, and in
    the ``_fsdp`` cases the weight rows over data): every step's logits
    block (batch over the batch axes, vocab over model) and the caches'
    blocks after the steps, whose new rows land in the owner shard only
    (position 16 starts a new shard); f32 at rtol and atol 1e-5."""
    ref, port = runs
    b, batch_axes, seq_axes, _, _ = LM_DECODE_CASES[name]
    cfg = ranks.lm_cfg(META)
    logit_spec = P(None, tuple(batch_axes) or None, "model")
    cache_spec = T.cache_specs(cfg, tuple(batch_axes), tuple(seq_axes))
    want = ref[f"lm_decode|{name}|logits"]
    assert want.shape == (LM_STEPS, b, 512) and np.isfinite(want).all()
    for r in port:
        got = r["outputs"][f"lm_decode|{name}|logits"]
        _close(got, _block(want, logit_spec, r["coords"]), (1e-5, 1e-5))
        for kv in ("k", "v"):
            _close(r["outputs"][f"lm_decode|{name}|{kv}"],
                   _block(ref[f"lm_decode|{name}|{kv}"], cache_spec, r["coords"]), (1e-5, 1e-5))


@pytest.mark.parametrize("name", list(LM_DECODE_CASES))
def test_lm_sharded_decode_bytes_follow_the_ring_model(runs, name):
    _, port = runs
    want = _lm_ring_bytes(name)
    for r in port:
        assert r["bytes"][f"lm_decode|{name}"] == want


def test_vocab_embed_under_the_mesh_matches_reference(runs):
    """``sharded_vocab_embed`` with the table by rows over model and the
    tokens by batch over data: each rank's block of the reference's lookup,
    bit-equal (one rank owns each row, the others add zeros), and the ring
    model's bytes of one all-reduce over model."""
    ref, port = runs
    for r in port:
        got = r["outputs"]["vocab_embed"]
        np.testing.assert_array_equal(got, _block(ref["vocab_embed"], P("data"), r["coords"]))
        nbytes = EMBED_SHAPE[0] // MESH[0] * EMBED_SHAPE[1] * DIM * 4
        assert r["bytes"]["vocab_embed"] == {"all_reduce": 2 * nbytes * (MESH[1] - 1) / MESH[1]}


def _lm_tp_where(r: dict, case: dict) -> tuple[dict, dict]:
    """A rank's coordinates and the mesh shape of an LM case's mesh."""
    if case["mesh"] == "pod":
        return r["coords3"], POD_MESH
    return r["coords"], dict(zip(("data", "model"), MESH))


def _lm_tp_grad_tol(want: np.ndarray):
    return (RTOL, 1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", list(LM_TP_CASES))
def test_lm_tp_forward_matches_reference(runs, name):
    """``forward`` under the mesh: each rank's [B_l, S, Vp / tp] block of the
    reference's logits (batch over the batch axes, vocab over model) and the
    aux (the experts' case: the mean of the batch blocks' Switch losses),
    rtol and atol 1e-5."""
    ref, port = runs
    case = LM_TP_CASES[name]
    ba = tuple(case["batch_axes"])
    want = ref[f"lmtp|{name}|logits"]
    assert np.isfinite(want).all()
    for r in port:
        coords, shape = _lm_tp_where(r, case)
        _close(r["outputs"][f"lmtp|{name}|logits"],
               _block(want, P(ba, None, "model"), coords, shape), (1e-5, 1e-5))
        _close(r["outputs"][f"lmtp|{name}|aux"], ref[f"lmtp|{name}|aux"], (1e-5, 1e-5))
    if case["moe"]:
        assert float(ref[f"lmtp|{name}|aux"]) > 0


@pytest.mark.parametrize("name", list(LM_TP_CASES))
def test_lm_tp_prefill_then_decode_matches_reference(runs, name):
    """``prefill`` under the mesh (the dense case through its serving cell,
    bf16 params with FSDP at use): the last logits' and the caches' blocks
    (``kv_spec``: KV heads over model where they divide tp); then
    ``caches_for_decode`` and 4 ``decode_step``s from them against the
    reference's decode from its caches padded to 32 positions: each step's
    logits block and the caches' ``cache_specs`` blocks after the steps."""
    ref, port = runs
    case = LM_TP_CASES[name]
    ba = tuple(case["batch_axes"])
    cfg = ranks.lm_tp_cfg(case)
    kv_spec = P(None, ba, None, "model" if cfg.kv_sharded(_lm_tp_mesh(case)) else None, None)
    cache_spec = T.cache_specs(cfg, ba, ("model",))
    for r in port:
        coords, shape = _lm_tp_where(r, case)
        out = r["outputs"]
        _close(out[f"lmtp|{name}|last"], _block(ref[f"lmtp|{name}|last"], P(ba, "model"),
                                                coords, shape), (1e-5, 1e-5))
        _close(out[f"lmtp|{name}|decode"], _block(ref[f"lmtp|{name}|decode"],
                                                  P(None, ba, "model"), coords, shape),
               (1e-5, 1e-5))
        for kv in ("k", "v"):
            _close(out[f"lmtp|{name}|prefill_{kv}"],
                   _block(ref[f"lmtp|{name}|prefill_{kv}"], kv_spec, coords, shape), (1e-5, 1e-5))
            _close(out[f"lmtp|{name}|decode_{kv}"],
                   _block(ref[f"lmtp|{name}|decode_{kv}"], cache_spec, coords, shape),
                   (1e-5, 1e-5))


@pytest.mark.parametrize("name", list(LM_TP_CASES))
def test_lm_tp_train_step_matches_reference(runs, name):
    """``make_train_step`` under the mesh with ``fsdp`` and 2 microbatches
    of a batch with masked labels: the loss, every gradient block under the
    reference's ``grad_specs`` (an optimizer that returns the gradients;
    atol 1e-5 times the leaf's largest magnitude) and every param block
    after one Adam step (rtol and atol 1e-5; eps 1e-3: at 1e-8 Adam's
    first step, g / (|g| + eps), turns the rounding of a gradient near 1e-8
    into a step up to 2e-5 apart); the dense case also one step of its
    Adafactor train cell (the factored means and the clip span the mesh)."""
    ref, port = runs
    case = LM_TP_CASES[name]
    ba = tuple(case["batch_axes"])
    cfg = dataclasses.replace(ranks.lm_tp_cfg(case), fsdp=True, microbatches=2)
    specs = {keystr(p): s for p, s in tree_flatten_with_path(
        T.mesh_param_specs(cfg, _lm_tp_mesh(case), ba), lambda x: isinstance(x, P))}
    opts = ["grads", "adam"] + (["adafactor"] if case["adafactor"] else [])
    for r in port:
        coords, shape = _lm_tp_where(r, case)
        out = r["outputs"]
        for opt in opts:
            _close(out[f"lmtp|{name}|{opt}_loss"], ref[f"lmtp|{name}|{opt}_loss"], (1e-5, 1e-5))
            for key, spec in specs.items():
                want = _block(ref[f"lmtp|{name}|{opt}|{key}"], spec, coords, shape)
                tol = _lm_tp_grad_tol(want) if opt == "grads" else (1e-5, 1e-5)
                _close(out[f"lmtp|{name}|{opt}|{key}"], want, tol)
        _close(out[f"lmtp|{name}|norm"], ref[f"lmtp|{name}|norm"], (1e-5, 1e-5))
    assert np.abs(ref[f"lmtp|{name}|grads|['layers']['wq']"]).max() > 0


def _lm_tp_ring_bytes(name: str) -> tuple[dict, dict]:
    """One rank's bytes of ``forward`` and of ``prefill`` +
    ``caches_for_decode`` + the decode steps by the ring model, f32
    activations.  Per layer: under seq_shard two all-gathers of the hidden
    [B_l, S, D] over model and two reduce-scatters into [B_l, S / tp, D],
    else two all-reduces of [B_l, S, D]; with FSDP the all-gathers of the
    layer's weights over the batch axes (the prefill cell's in bf16).  The
    token embedding is a reduce-scatter (seq_shard) or an all-reduce; the
    head takes the gathered hidden state (forward) or the last position's;
    the experts' aux one scalar all-reduce over the mesh.  The handoff
    gathers sharded KV heads over model; the decode steps take the same
    params (``_decode_ring_bytes``, FSDP over the batch axes)."""
    case = LM_TP_CASES[name]
    cfg, am = ranks.lm_tp_cfg(case), _lm_tp_mesh(case)
    tp, dp = am.shape["model"], am.axis_size(case["batch_axes"])
    world = am.axis_size(tuple(am.shape))
    (b, s), D, dh = LM_TP_SHAPE, cfg.d_model, cfg.d_head
    bl, hid = b // dp, b // dp * s * cfg.d_model * 4
    hl, hkv_l = cfg.padded_heads(am) // tp, cfg.n_kv_heads // (tp if cfg.kv_sharded(am) else 1)
    weights = D * hl * dh * 2 + 2 * D * hkv_l * dh
    if cfg.dense_ffn():
        weights += 3 * D * cfg.d_ff // tp
    if cfg.moe:
        weights += 3 * cfg.moe.num_experts // tp * D * cfg.moe.d_ff

    def layers(item: int) -> dict:
        per = {}
        if cfg.seq_shard:
            per = {"all_gather": 2 * hid * (tp - 1) / tp, "reduce_scatter": 2 * hid // tp * (tp - 1)}
        else:
            per = {"all_reduce": 2 * 2 * hid * (tp - 1) / tp}
        if cfg.fsdp:
            per["all_gather"] = per.get("all_gather", 0) + weights * item * (dp - 1) / dp
        return {op: cfg.n_layers * v for op, v in per.items()}

    def add(into: dict, op: str, v: float) -> None:
        into[op] = into.get(op, 0) + v

    fwd, pre = layers(4), layers(2 if case["adafactor"] else 4)
    for part in (fwd, pre):
        if cfg.seq_shard:
            add(part, "reduce_scatter", hid // tp * (tp - 1))
        else:
            add(part, "all_reduce", 2 * hid * (tp - 1) / tp)
    if cfg.seq_shard:
        add(fwd, "all_gather", hid * (tp - 1) / tp)
        add(pre, "all_gather", bl * tp * D * 4 * (tp - 1) / tp)
    if cfg.moe:
        add(fwd, "all_reduce", 2 * 4 * (world - 1) / world)
    if cfg.kv_sharded(am):
        add(pre, "all_gather", 2 * cfg.n_layers * bl * s * cfg.n_kv_heads * dh * 4 * (tp - 1) / tp)
    for op, v in _decode_ring_bytes(cfg, am, b, case["batch_axes"], ["model"], LM_TP_STEPS,
                                    case["batch_axes"]).items():
        add(pre, op, v)
    return fwd, pre


def _lm_tp_train_ring_bytes(name: str) -> dict:
    """One rank's bytes over one ``make_train_step`` (fsdp, 2 microbatches)
    by the ring model.  The step all-gathers the tokens and the labels over
    the batch axes (each rank's rows of the reference's microbatches).  Per
    microbatch, under the two-level remat of L layers in G groups: the
    hidden state [B_l / 2, S, D] collectives of the forward (the embedding's
    and two a layer, two gathers and the head's), of each group's
    recompute up to its last layer, of each layer's own (two gathers, one
    sum: it stops after its FFN product) and of the backward (each one's
    transpose); the layer weights' all-gathers at each of the 3 L - G uses
    and their gradients' reduce-scatter once; the loss (a row max, two row
    sums over model, two scalars over the batch axes) and the experts' aux
    (a scalar over the mesh); the gradients summed by ``grad_sum_axes``."""
    case = LM_TP_CASES[name]
    cfg = dataclasses.replace(ranks.lm_tp_cfg(case), fsdp=True, microbatches=2)
    am = _lm_tp_mesh(case)
    ba = tuple(case["batch_axes"])
    tp, dp, world = am.shape["model"], am.axis_size(ba), am.axis_size(tuple(am.shape))
    L_, G_, D, dh = cfg.n_layers, cfg.groups(), cfg.d_model, cfg.d_head
    B, S = LM_TP_TRAIN_BATCH, LM_TP_SHAPE[1]
    bl = B // dp // cfg.microbatches
    hid = bl * S * D * 4
    kv = cfg.kv_sharded(am)
    hl, hkv_l = cfg.padded_heads(am) // tp, cfg.n_kv_heads // (tp if kv else 1)
    w = D * dh * (2 * hl + 2 * hkv_l) + 3 * D * cfg.d_ff // tp
    if cfg.moe:
        w += 3 * cfg.moe.num_experts // tp * D * cfg.moe.d_ff
    per = {"all_gather": (3 * L_ - G_) * w * 4 * (dp - 1) / dp,
           "reduce_scatter": L_ * w * 4 // dp * (dp - 1),
           "all_reduce": 2 * 2 * bl * S * 4 * (tp - 1) / tp + 2 * 2 * 4 * (dp - 1) / dp,
           "all_reduce_max": 2 * bl * S * 4 * (tp - 1) / tp}
    if cfg.seq_shard:
        per["all_gather"] += (8 * L_ - 2 * G_ + 2) * hid * (tp - 1) / tp
        per["reduce_scatter"] += (7 * L_ - 2 * G_ + 2) * hid // tp * (tp - 1)
    else:
        per["all_reduce"] += (7 * L_ - 2 * G_ + 2) * 2 * hid * (tp - 1) / tp
    if cfg.moe:
        per["all_reduce"] += 2 * 4 * (world - 1) / world
    # the gradients' sums, f32, grouped by their axes
    data = 2 * cfg.padded_vocab(am) // tp * D  # the token table's and the head's blocks
    both, model = 0, 0
    norms = (2 * L_ + 1) * D
    if cfg.seq_shard:
        both += norms
    else:
        data += norms
    if cfg.moe:
        both += L_ * D * cfg.moe.num_experts  # the router
    if cfg.qkv_bias:
        data += L_ * hl * dh  # bq's block
        if kv:
            data += 2 * L_ * hkv_l * dh
        else:
            both += 2 * L_ * cfg.n_kv_heads * dh
    if not kv:
        model += 2 * L_ * D // dp * cfg.n_kv_heads * dh  # wk, wv: their FSDP blocks
    per["all_reduce"] += (2 * data * 4 * (dp - 1) / dp + 2 * both * 4 * (dp * tp - 1) / (dp * tp)
                          + 2 * model * 4 * (tp - 1) / tp)
    out = {op: cfg.microbatches * v for op, v in per.items()}
    out["all_gather"] += 2 * B * S * 4 * (dp - 1) / dp  # the microbatches' rows
    return out


@pytest.mark.parametrize("name", list(LM_TP_CASES))
def test_lm_tp_bytes_follow_the_ring_model(runs, name):
    _, port = runs
    fwd, pre = _lm_tp_ring_bytes(name)
    train = _lm_tp_train_ring_bytes(name)
    for r in port:
        assert r["bytes"][f"lmtp_forward|{name}"] == fwd
        assert r["bytes"][f"lmtp_prefill|{name}"] == pre
        assert r["bytes"][f"lmtp_train|{name}"] == train


# ----------------------------------------------------------------------- GNN


def _gnn_trees(got: dict, want: dict, tol=(RTOL, ATOL), scaled=False) -> None:
    """Leaves by key (``prefix|<keystr>``), each on every rank whole."""
    assert sorted(got) == sorted(want) and got
    for key in got:
        scale = max(1.0, float(np.abs(want[key]).max())) if scaled else 1.0
        _close(got[key], want[key], (tol[0], tol[1] * scale))


def _leaves(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _gnn_hidden_ring_bytes(cfg: G.GNNConfig) -> float:
    """One all-reduce of a hidden layer's [N, d_hidden] f32 cotangent a
    layer past the first."""
    n_dev = MESH[0] * MESH[1]
    return (cfg.n_layers - 1) * M.ring_bytes("all_reduce", GNN_N * cfg.d_hidden * 4, n_dev)


def test_gnn_edge_sharded_forward_matches_reference(runs):
    """Every rank's logits (whole) against the reference's mesh run and its
    one-device run; the bytes are the ring model's (every layer's sums, the
    counts once) and the compiled HLO's."""
    ref, port = runs
    cfg = G.GNNConfig(**GNN_CFG)
    want = {"all_reduce": G.full_graph_ring_bytes(cfg, GNN_N, MESH[0] * MESH[1])}
    assert sum(want.values()) == float(ref["hlo_bytes|gnn_fwd"])
    for r in port:
        for where in ("mesh", "one"):
            _close(r["outputs"]["gnn|fwd"], ref[f"gnn|fwd|{where}"])
        assert r["bytes"]["gnn_fwd"] == want


def test_gnn_edge_sharded_train_step_matches_reference(runs):
    """``make_train_step_full(mesh=...)``: the loss and gradients (whole on
    every rank: no gradient sum) and one Adam step, against the reference's
    mesh run and its one-device run.  Bytes: the forward's, then one
    all-reduce of the aggregation's input cotangent a layer past the first
    (``launch.mesh.copy_to``'s backward); the reference's transpose
    all-reduces that cotangent twice (the psum's transpose, then the
    replicated input's), so its HLO moves one more such all-reduce."""
    ref, port = runs
    cfg = G.GNNConfig(**GNN_CFG)
    fwd = G.full_graph_ring_bytes(cfg, GNN_N, MESH[0] * MESH[1])
    want = {"all_reduce": fwd + _gnn_hidden_ring_bytes(cfg)}
    assert float(ref["hlo_bytes|gnn_train"]) == want["all_reduce"] + _gnn_hidden_ring_bytes(cfg)
    for r in port:
        out = r["outputs"]
        for where in ("mesh", "one"):
            _close(out["gnn|full_loss"], ref[f"gnn|full_loss|{where}"])
            _gnn_trees(_leaves(out, "gnn|full_grads|"),
                       _leaves(ref, f"gnn|full_grads|{where}|"), scaled=True)
            _gnn_trees(_leaves(out, "gnn|full_adam|"), _leaves(ref, f"gnn|full_adam|{where}|"))
        assert r["bytes"]["gnn_train"] == want


@pytest.mark.parametrize("comm", ["f32", "bf16"])
def test_gnn_partitioned_forward_matches_reference(runs, comm):
    """``forward_full_graph_partitioned``: each rank's block of the logits
    against the reference's under its mesh (same comm dtype) and against the
    one-device forward of the whole graph.  f32 at 1e-5; bf16 comm rounds
    every node state to 8 bits of mantissa before the aggregation, so it is
    held at the bf16 partials' 2e-2, as the lookup's bf16 cases.  Bytes:
    one all-gather of h a layer in the comm dtype (XLA's CPU backend runs
    the bf16 one in f32: its HLO moves the f32 bytes)."""
    ref, port = runs
    cfg = G.GNNConfig(**GNN_CFG)
    n_dev = MESH[0] * MESH[1]
    tol = (BF16_TOL, BF16_TOL) if comm == "bf16" else (RTOL, ATOL)
    dt = torch.bfloat16 if comm == "bf16" else torch.float32
    spec = P(("data", "model"))
    for r in port:
        got = r["outputs"][f"gnn|part|{comm}"]
        assert got.shape == (GNN_N // n_dev, cfg.n_classes)
        _close(got, _block(ref[f"gnn|part|{comm}"], spec, r["coords"]), tol)
        _close(got, _block(ref["gnn|fwd|one"], spec, r["coords"]), tol)
        assert r["bytes"][f"gnn_part|{comm}"] == {
            "all_gather": G.partitioned_ring_bytes(cfg, GNN_N, n_dev, dt)}
    assert float(ref[f"hlo_bytes|gnn_part|{comm}"]) == G.partitioned_ring_bytes(
        cfg, GNN_N, n_dev, torch.float32)
    # a quarter of the edge-sharded forward's bytes at (2, 2) and bf16: here
    # (8 ranks, f32) the all-gathers move a half of the all-reduces' sums
    assert G.partitioned_ring_bytes(cfg, GNN_N, n_dev, torch.float32) * 2 == pytest.approx(
        G.full_graph_ring_bytes(cfg, GNN_N, n_dev) - M.ring_bytes("all_reduce", GNN_N * 4, n_dev))


def _reference_adam_step(params, grads: dict) -> dict:
    """The reference's ``make_adam(1e-3)`` stepping ``params`` (whole, nested
    torch tensors) by ``grads`` (by keystr) from its initial state: the new
    params by keystr."""
    import jax
    import jax.numpy as jnp

    from repro.optim import optimizers as JO

    g = tree_unflatten(params, [grads[keystr(p)] for p, _ in tree_flatten_with_path(params)])
    to_jax = functools.partial(tree_map, lambda t: jnp.asarray(np.asarray(t)))
    adam = JO.make_adam(1e-3)
    p = to_jax(params)
    new_p, _ = adam.update(to_jax(g), adam.init(p), p)
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(new_p)[0]}


@pytest.mark.parametrize("shape", GNN_CELLS)
def test_gnn_cell_steps_match_reference(runs, dry_inputs, shape):
    """The minibatch and molecule cells under the mesh: each rank's share of
    the loss and gradients summed over the mesh (the global batch's), and
    the cell's Adam step, against the reference's mesh run (the batch laid
    out by the cell's in_shardings) and its one-device run: the Adam state
    against theirs, the params against the reference's ``make_adam``
    applied to the rank's own gradients.  Adam's first step is
    lr g / (|g| + 1e-8): at a gradient near 1e-8 it turns the gradients'
    rounding, well inside their tolerance, into a step apart (on other
    draws 1.55e-6 at a gradient of 6.09e-9 against 6.05e-9, and 4.74e-6,
    past STEP_TOL).  Bytes: one all-reduce of the loss and of each gradient
    leaf, as the compiled HLO's."""
    ref, port = runs
    from repro_torch.configs import graphsage_reddit as GR

    info = {**GR.SHAPES[shape], **(GNN_MINIBATCH if shape == "minibatch_lg" else {})}
    cfg = GR._cfg(info)
    n_dev = MESH[0] * MESH[1]
    leaves = [t.numel() * 4 for _, t in tree_flatten_with_path(G.abstract_params(cfg))]
    want = {"all_reduce": sum(M.ring_bytes("all_reduce", b, n_dev) for b in leaves + [4])}
    params = ranks.gnn_params(dry_inputs, f"gnn_cellp|{shape}")
    for r in port:
        out = r["outputs"]
        grads = _leaves(out, f"gnn|cell_grads|{shape}|")
        step = _leaves(out, f"gnn|cell_step|{shape}|")
        stepped = _reference_adam_step(params, grads)
        _gnn_trees({k: v for k, v in step.items() if k in stepped}, stepped)
        for where in ("mesh", "one"):
            _close(out[f"gnn|cell_loss|{shape}"], ref[f"gnn|cell_loss|{shape}|{where}"])
            _close(out[f"gnn|cell_step_loss|{shape}"],
                   ref[f"gnn|cell_step_loss|{shape}|{where}"])
            _gnn_trees(grads, _leaves(ref, f"gnn|cell_grads|{shape}|{where}|"), scaled=True)
            want_step = _leaves(ref, f"gnn|cell_step|{shape}|{where}|")
            assert sorted(step) == sorted(want_step)
            _gnn_trees({k: v for k, v in step.items() if k.startswith("state")},
                       {k: v for k, v in want_step.items() if k.startswith("state")})
        assert r["bytes"][f"gnn_cell|{shape}"] == want
    assert float(ref[f"hlo_bytes|gnn_cell|{shape}"]) == want["all_reduce"]


def test_gnn_molecule_uneven_blocks_match_one_device(runs, dry_inputs):
    """The molecule cell where `model` does not divide a data rank's graphs
    (``gnn.model_block``: blocks of one graph, the last model rank's empty):
    each rank's loss and gradients against one device's on the whole batch,
    and its Adam step at STEP_TOL (Adam's first step divides a gradient by
    its own magnitude, so a near-zero entry magnifies the sums' order)."""
    _, port = runs
    from repro_torch.configs import graphsage_reddit as GR

    n = ranks.MOLECULE_UNEVEN * MESH[0]
    batch = {k: v[:n] for k, v in ranks.nest(dry_inputs, "gnn_cell|molecule").items()}
    params = ranks.gnn_params(dry_inputs, "gnn_cellp|molecule")
    loss_fn = GR.molecule_loss(GR._cfg(GR.SHAPES["molecule"]))
    loss, grads = G.loss_and_grads(loss_fn, params, batch)
    adam = O.make_adam(1e-3)
    new_p, new_s, met = G.make_train_step(loss_fn, adam)(params, adam.init(params), batch)
    step = {**ranks.flat_np(new_p), **{"state" + k: v for k, v in ranks.flat_np(new_s).items()}}
    blocks = [int(r["outputs"]["gnn|uneven|block_graphs"]) for r in port]
    assert blocks == [1, 1, 1, 0] * MESH[0]
    for r in port:
        out = r["outputs"]
        _close(out["gnn|uneven|loss"], loss.numpy())
        _close(out["gnn|uneven|step_loss"], met["loss"].numpy())
        _gnn_trees(_leaves(out, "gnn|uneven|grads|"), ranks.flat_np(grads), scaled=True)
        _gnn_trees(_leaves(out, "gnn|uneven|step|"), step, STEP_TOL)


def test_ranks_sit_row_major_and_refuse(runs):
    _, port = runs
    for rank, r in enumerate(port):
        assert r["coords"] == {"data": rank // MESH[1], "model": rank % MESH[1]}
        assert "needs 256 ranks; the world has 8" in r["errors"]["production_mesh"]
        assert "plain sharded fields only" in r["errors"]["mesh2d_replicated"]


def test_refusals_in_one_process():
    with pytest.raises(ValueError, match="unknown lookup mode"):
        DisaggEmbedding([TableSpec("a", 10)], dim=4, num_shards=1, mode="ring")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks; the world has 1"):
            M.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError, match="needs that many ranks"):
        M.make_debug_mesh(2, 4)


@pytest.mark.parametrize("which", ["lookup_rows", "gather_rows"])
def test_mesh2d_rows_refuse_and_say_why(which):
    """Under a mesh ``lookup_rows`` and ``gather_rows`` read the paper layout
    only: the reference's mesh2d versions do not give its one-device result
    (ROADMAP, Quirks of the reference), so there is none to port."""
    emb = DisaggEmbedding(ranks.specs_of(EMB_SPECS), dim=DIM, num_shards=8, mode="mesh2d")
    mesh = M.DryMesh(MESH, ("data", "model"))
    table = {"table": torch.empty((emb.sharded.total_rows // 8, DIM), device="meta")}
    ids = torch.zeros((B, len(EMB_SPECS), 4), dtype=torch.int32, device="meta")
    call = {"lookup_rows": lambda: emb.lookup_rows(table, ids, ids > 0, mesh=mesh),
            "gather_rows": lambda: emb.gather_rows(table, ids[:, 0, 0], mesh=mesh)}[which]
    with pytest.raises(NotImplementedError,
                       match=f"reference's mesh2d {which} is not its one-device {which}"):
        call()


def test_spawn_returns_per_rank_and_fails_loudly():
    assert M.spawn(ranks.echo_coords, 4, ((2, 2),), timeout=60) == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        M.spawn(ranks.fail_on_rank_1, 2, timeout=60)
    with pytest.raises(TimeoutError, match="killed"):
        M.spawn(ranks.sleep, 1, (60,), timeout=3)


# ---- the dry run's trace of the same programs against the compiled HLO


HLO_CASES = sorted(LOOKUP_CASES) + ["lookup_rows", "gather_rows", "pod|hierarchical",
                                    "pod|mesh2d", "gnn_fwd", "gnn_train", "gnn_part|f32",
                                    "gnn_part|bf16", "gnn_cell|minibatch_lg", "gnn_cell|molecule"
                                    ] + [f"lm_decode|{name}" for name in LM_DECODE_CASES]


@pytest.fixture(scope="module")
def dry_inputs():
    """The inputs the ``runs`` fixture writes (the same seed)."""
    return _inputs(np.random.default_rng(0))


def _meta_block(arr, spec, mesh) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr[M.block_slices(arr.shape, spec, mesh)])
                            ).to("meta")


def _to_meta(state):
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).to("meta")
                                         for f in dataclasses.fields(state)})


def _dry_trace(key: str, d: dict, monkeypatch):
    """Rank 0's part of the case ``key`` on meta tensors under a ``DryMesh``
    of the test's mesh, traced as ``launch.dryrun`` traces a cell: the same
    calls as ``tests/_torch_sharded_ranks.py`` makes on its blocks."""
    from repro_torch.configs import graphsage_reddit as GR
    from repro_torch.core.embedding import make_cache_from_table, make_hash_cache_from_table
    from repro_torch.launch.hlo_analysis import Trace

    meta = json.loads(str(d["meta"]))
    pod = key.startswith("pod|")
    mesh = (M.DryMesh(tuple(POD_MESH.values()), tuple(POD_MESH)) if pod
            else M.DryMesh(MESH, ("data", "model")))
    axes = tuple(mesh.axis_names)
    batch_axes = ("pod", "data") if pod else ranks.BATCH_AXES
    name = key.split("|", 1)[-1]
    if name in LOOKUP_CASES or key in ("lookup_rows", "gather_rows"):
        case = (POD_CASES if pod else LOOKUP_CASES)[name if name in LOOKUP_CASES
                                                    else "hierarchical"]
        emb = DisaggEmbedding(ranks.specs_of(EMB_SPECS), dim=DIM, num_shards=case["num_shards"],
                              mode=case["mode"], replicated_fields=tuple(case["replicated"]),
                              comm_dtype=torch.bfloat16 if case["comm"] == "bf16" else None)
        specs = emb.param_specs(batch_axes)
        whole = {k: d[f"{case['params']}|{k}"] for k in specs}
        params = {k: _meta_block(v, specs[k], mesh) for k, v in whole.items()}
        idx, msk = (_meta_block(d[k], P(batch_axes), mesh) for k in ("idx", "mask"))
        cache = None
        if case["cache"]:
            make = make_cache_from_table if case["cache"] == "flat" else make_hash_cache_from_table
            slots = meta["flat_slots"] if case["cache"] == "flat" else meta["hash_slots"]
            cache = _to_meta(make(emb, {k: torch.from_numpy(v) for k, v in whole.items()},
                                  d["hot"], slots, device="cpu"))
        with Trace() as tr:
            if key == "lookup_rows":
                emb.lookup_rows(params, idx, msk, mesh=mesh)
            elif key == "gather_rows":
                emb.gather_rows(params, torch.from_numpy(d["row_ids"]).to("meta"), mesh=mesh)
            else:
                emb.lookup(params, idx, msk, mesh=mesh, cache=cache, batch_axes=batch_axes,
                           num_chunks=case["num_chunks"])
        return tr
    to_meta = functools.partial(tree_map, lambda t: t.to("meta"))
    if key.startswith("lm_decode|"):  # the case's steps at LM_HLO_D_HEAD, from shapes
        b, ba, sa, _, _ = LM_DECODE_CASES[name]
        ba, sa = tuple(ba), tuple(sa)
        cfg = _lm_case_cfg(name, hlo=True)
        params = R.shard_params(T.abstract_params(cfg, mesh), T.mesh_param_specs(
            cfg, mesh, batch_axes), mesh)
        spec = T.cache_specs(cfg, ba, sa)
        shape = (cfg.n_layers, b, LM_CACHE, cfg.n_kv_heads, cfg.d_head)
        cache = tuple(L.constrain(torch.empty(shape, device="meta"), spec, mesh).contiguous()
                      for _ in range(2))
        toks = L.constrain(torch.empty((LM_STEPS, b), dtype=torch.int32, device="meta"),
                           P(None, ba or None), mesh)
        with Trace() as tr, torch.no_grad():
            for i in range(LM_STEPS):
                T.decode_step(cfg, params, cache, toks[i], torch.empty(
                    (), dtype=torch.int32, device="meta"), mesh, ba, sa, fsdp_axes=batch_axes)
        return tr
    cfg = G.GNNConfig(**GNN_CFG)
    if key.startswith("gnn_cell|"):
        monkeypatch.setitem(GR.SHAPES, "minibatch_lg", {
            **GR.SHAPES["minibatch_lg"], **GNN_MINIBATCH, "fanout": tuple(GNN_MINIBATCH["fanout"])})
        cell = GR.build_cell(name, mesh, False)
        params = to_meta(ranks.gnn_params(d, f"gnn_cellp|{name}"))
        batch = {k: _meta_block(v.numpy(), cell.in_shardings[2][k], mesh)
                 for k, v in ranks.nest(d, f"gnn_cell|{name}").items()}
        adam = O.make_adam(1e-3)
        state = adam.init(params)
        with Trace() as tr:
            cell.step_fn(params, state, batch)
        return tr
    params = to_meta(ranks.gnn_params(d))
    full = {k: d[f"gnn_full|{k}"] for k in ("feats", "edges", "edge_mask", "labels")}
    b = {"feats": torch.from_numpy(full["feats"]).to("meta"),
         "labels": torch.from_numpy(full["labels"]).to("meta"),
         "edges": _meta_block(full["edges"], P(axes, None), mesh),
         "edge_mask": _meta_block(full["edge_mask"], P(axes), mesh)}
    with Trace() as tr:
        if key == "gnn_fwd":
            with torch.no_grad():
                G.forward_full_graph(cfg, params, b["feats"], b["edges"], b["edge_mask"], mesh)
        elif key == "gnn_train":
            G.make_train_step_full(cfg, ranks.grads_of(), mesh)(params, (), b)
        else:
            dt = torch.bfloat16 if name == "bf16" else torch.float32
            with torch.no_grad():
                G.forward_full_graph_partitioned(
                    cfg, params, _meta_block(full["feats"], P(axes, None), mesh),
                    _meta_block(d["gnn_part|edges"], P(axes, None), mesh),
                    _meta_block(d["gnn_part|edge_mask"], P(axes), mesh), mesh, comm_dtype=dt)
    return tr


def _xla_decode_differences(name: str) -> tuple[float, float]:
    """``(bytes, flops)`` by which the reference's compiled decode steps
    exceed the port's, named: (a) over several sequence axes XLA splits the
    max all-reduce of the row maxima into one a mesh axis; (b) with FSDP
    over the batch and KV heads that do not divide tp, XLA moves each rank
    a [D / tp, Hkv dh] row block of ``wk`` and of ``wv`` by a
    collective-permute, multiplies it by its D / tp slice of the normed
    state and all-reduces the partial k and v [B_l, Hkv dh] over model,
    where the port all-gathers both weights over data and computes every
    KV head from the whole of D (fewer FLOPs on XLA's side)."""
    b, batch_axes, seq_axes, fsdp, _ = LM_DECODE_CASES[name]
    cfg, am = _lm_case_cfg(name, hlo=True), M.AbstractMesh(MESH, ("data", "model"))
    ar = lambda n, g: 2 * n * (g - 1) / g  # noqa: E731
    bl = b // am.axis_size(tuple(batch_axes))
    rows = bl * cfg.padded_heads(am) * 4
    extra, flops = 0.0, 0.0
    if len(seq_axes) > 1:
        extra += sum(ar(rows, am.shape[a]) for a in seq_axes) - ar(rows, am.axis_size(seq_axes))
    if fsdp and batch_axes and not cfg.kv_sharded(am):
        tp, dp = am.shape["model"], am.axis_size(("data",))
        kv = cfg.n_kv_heads * cfg.d_head
        w = cfg.d_model * kv * 4
        extra += 2 * (w / tp + ar(bl * kv * 4, tp) - w * (dp - 1) / dp)
        flops -= 2 * 2 * bl * cfg.d_model * kv * (tp - 1) / tp
    n = LM_STEPS * cfg.n_layers
    return n * extra, n * flops


@pytest.mark.parametrize("key", HLO_CASES)
def test_dry_trace_matches_the_compiled_hlo(runs, dry_inputs, monkeypatch, key):
    """Rank 0's part of each case traced on meta under a ``DryMesh`` of the
    test's mesh (``launch.hlo_analysis.Trace``, as the dry run traces a
    cell): its collective bytes are the bytes rank 0 counted on the real
    mesh and the reference's compiled HLO's, but for the documented
    differences (XLA's CPU backend runs a bf16 collective in f32; the GNN
    backward's one more all-reduce of a hidden cotangent, ROADMAP Quirks;
    the LM decode's, ``_xla_decode_differences``); its FLOPs are the HLO's
    dots', but for these named ops: the hand kernels' products (K1's and
    K3's FMAs, where the reference gathers and reduces without a dot; K7's
    shard mode is the reference's two dots), the decode's k and v products
    (``_xla_decode_differences``), and the molecule forward, whose compiled
    program computes a data rank's graphs on each of its `model` ranks (the
    sharding constraint sits on the output) where the port computes its
    block of them."""
    ref, port = runs
    name = key.split("|", 1)[-1]
    tr = _dry_trace(key, dry_inputs, monkeypatch)
    # the decode programs run here at another head dim than on the ranks,
    # whose bytes the ring model holds (test_lm_sharded_decode_bytes_...)
    assert tr.collective_bytes() == (_lm_ring_bytes(name, hlo=True) if key.startswith(
        "lm_decode|") else port[0]["bytes"][key])
    # XLA's CPU backend moves these ops' bf16 payloads in f32
    f32_on_cpu = {"hierarchical_bf16": "all_reduce", "mesh2d_bf16": "reduce_scatter",
                  "gnn_part|bf16": "all_gather"}.get(key)
    got = sum(v * (2 if op == f32_on_cpu else 1) for op, v in tr.collective_bytes().items())
    if key == "gnn_train":
        got += _gnn_hidden_ring_bytes(G.GNNConfig(**GNN_CFG))
    decode = _xla_decode_differences(name) if key.startswith("lm_decode|") else (0.0, 0.0)
    got += decode[0]
    assert got == float(ref[f"hlo_bytes|{key}"])
    kernels = {name: k["f32"] for name, k in tr.kernels.items() if "bytes" in k}
    assert set(kernels) <= {"embedding_bag", "probe_gather_pool", "flash_decode"}
    assert sum(tr.flops.values()) == sum(tr.aten_flops.values()) + sum(kernels.values())
    aten = sum(tr.aten_flops.values()) * (MESH[1] if key == "gnn_cell|molecule" else 1)
    # the reference's attention over a sequence shard is two dots, K7's work here
    aten += kernels.get("flash_decode", 0.0) + decode[1]
    assert aten == pytest.approx(float(ref[f"hlo_flops|{key}"]), rel=1e-2)
