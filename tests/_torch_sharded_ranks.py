"""The port's side of tests/test_torch_sharded.py: one rank of a (data 2,
model 4) mesh over gloo on the CPU.  ``run`` reads the inputs the test wrote
(a .npz whose ``meta`` entry is the JSON case list), runs every case on this
rank's blocks and returns host arrays: this rank's blocks of each output,
its mesh coordinates and the collective bytes it counted per case.

It imports torch and the port only (no jax), so it starts quickly in a
spawned process."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.embedding import (DisaggEmbedding, make_cache_from_table,
                                        make_hash_cache_from_table)
from repro_torch.core.lookup_engine import chunked_lookup
from repro_torch.core.sharding import AXIS_DATA, PartitionSpec as P, TableSpec
from repro_torch.hotcache.table import cache_partition_spec
from repro_torch.launch import mesh as M
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as O
from repro_torch.utils import keystr, tree_flatten_with_path, tree_map

BATCH_AXES = (AXIS_DATA,)
# The LM train step's Adam: at the default eps of 1e-8 the first step is
# g / (|g| + 1e-8), which turns the rounding of a gradient near 1e-8 (the
# collectives' summation order against XLA's) into a step 1e-4 apart.
ADAM_EPS = 1e-3
MOLECULE_UNEVEN = 3  # molecule graphs a data rank: over 4 model ranks 1, 1, 1, 0


def specs_of(rows) -> list[TableSpec]:
    return [TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in rows]


def nest(flat: dict, prefix: str) -> dict:
    """``{"a|b": x}`` entries under ``prefix|`` as nested dicts of tensors;
    a node whose keys are all indices (``attn|0|wq``) is a list."""
    out: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "|"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("|")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(arr))
    return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def flat_np(tree) -> dict:
    return {keystr(p): x.detach().cpu().numpy() for p, x in tree_flatten_with_path(tree)}


def dlrm_cfg(meta: dict, mode: str) -> R.RecsysConfig:
    return R.RecsysConfig(name="t", arch="dlrm", tables=tuple(specs_of(meta["dlrm_specs"])),
                          embed_dim=meta["dim"], n_dense=meta["n_dense"],
                          bottom_mlp=tuple(meta["bottom_mlp"]), mlp=tuple(meta["mlp"]),
                          mode=mode)


def arch_cfg(meta: dict, name: str) -> R.RecsysConfig:
    """The recsys arch case ``name`` of ``meta["arch_cases"]``."""
    case = meta["arch_cases"][name]
    kw = dict(meta["arch_specs"][case["arch"]])
    tables = tuple(specs_of(kw.pop("tables")))
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    return R.RecsysConfig(name=name, tables=tables, embed_dim=meta["dim"], mode=case["mode"],
                          **kw, **case["over"])


def lm_cfg(meta: dict, fsdp: bool = False) -> T.TransformerConfig:
    """The tiny MoE LM of the sharded decode cases, f32 compute; with
    ``fsdp`` its weight rows split over the batch axes (a serving cell's
    ``fsdp_serve``)."""
    return T.TransformerConfig(**meta["lm"], moe=MOE.MoEConfig(**meta["lm_moe"]),
                               compute_dtype=torch.float32, fsdp=fsdp)


def optimizer() -> O.Optimizer:
    return O.make_composite([("emb", O.make_rowwise_adagrad(0.05)), (".*", O.make_adam(1e-3))])


def recsys_optimizer() -> O.Optimizer:
    """The registry's mix: rowwise AdaGrad on both tables, Adam elsewhere."""
    return O.make_composite([("emb|wide", O.make_rowwise_adagrad(0.05)),
                             (".*", O.make_adam(1e-3))])


def _bytes_since(before: dict) -> dict:
    now = M.comm_bytes()
    return {op: v - before.get(op, 0.0) for op, v in now.items() if v != before.get(op, 0.0)}


def run(rank: int, world: int, inputs_path: str) -> dict:
    torch.set_num_threads(1)
    d = dict(np.load(inputs_path))
    meta = json.loads(str(d["meta"]))
    mesh = M.make_debug_mesh(*meta["mesh"])
    out: dict = {"coords": dict(mesh.coords), "outputs": {}, "bytes": {}, "errors": {}}
    batch_p = P(BATCH_AXES)
    idx = L.constrain(torch.from_numpy(d["idx"]), batch_p, mesh)
    msk = L.constrain(torch.from_numpy(d["mask"]), batch_p, mesh)

    def emb_for(case: dict) -> DisaggEmbedding:
        return DisaggEmbedding(specs_of(meta["emb_specs"]), dim=meta["dim"],
                               num_shards=case["num_shards"], mode=case["mode"],
                               replicated_fields=tuple(case["replicated"]),
                               comm_dtype=torch.bfloat16 if case["comm"] == "bf16" else None)

    def local_params(emb: DisaggEmbedding, key: str) -> dict:
        whole = nest(d, key)
        specs = emb.param_specs(BATCH_AXES)
        return {k: L.constrain(v, specs[k], mesh) for k, v in whole.items()}

    # ---- lookups, the cache builds, lookup_rows and gather_rows
    for name, case in meta["lookup_cases"].items():
        emb = emb_for(case)
        params = local_params(emb, case["params"])
        cache = None
        if case["cache"] == "flat":
            cache = make_cache_from_table(emb, params, d["hot"], meta["flat_slots"], mesh=mesh,
                                          device="cpu")
        elif case["cache"] == "hash":
            cache = make_hash_cache_from_table(emb, params, d["hot"], meta["hash_slots"],
                                               mesh=mesh, device="cpu")
        before = M.comm_bytes()
        got = emb.lookup(params, idx, msk, mesh=mesh, cache=cache, batch_axes=BATCH_AXES,
                         num_chunks=case["num_chunks"])
        out["bytes"][name] = _bytes_since(before)
        out["outputs"][f"lookup|{name}"] = got.numpy()
    emb = emb_for(meta["lookup_cases"]["hierarchical"])
    params = local_params(emb, meta["lookup_cases"]["hierarchical"]["params"])
    before = M.comm_bytes()
    out["outputs"]["lookup_rows"] = emb.lookup_rows(params, idx, msk, mesh=mesh).numpy()
    out["bytes"]["lookup_rows"] = _bytes_since(before)
    before = M.comm_bytes()
    out["outputs"]["chunked_lookup"] = chunked_lookup(emb, params, idx, msk, mesh, 2,
                                                      batch_axes=BATCH_AXES).numpy()
    out["bytes"]["chunked_lookup"] = _bytes_since(before)
    spec = cache_partition_spec()
    out["cache_partition_spec"] = {f: list(getattr(spec, f)) for f in ("keys", "rows", "freq")}
    before = M.comm_bytes()
    out["outputs"]["gather_rows"] = emb.gather_rows(
        params, torch.from_numpy(d["row_ids"]), mesh=mesh).numpy()
    out["bytes"]["gather_rows"] = _bytes_since(before)

    # ---- the table's gradient of the lookup's sum, each output row once
    for mode in meta["grad_modes"]:
        case = meta["lookup_cases"][mode]
        emb = emb_for(case)
        table = local_params(emb, case["params"])["table"].clone().requires_grad_(True)
        before = M.comm_bytes()
        pooled = emb.lookup({"table": table}, idx, msk, mesh=mesh, batch_axes=BATCH_AXES)
        loss = R.dense_shard(pooled, BATCH_AXES, mesh, have=emb.output_axes(BATCH_AXES)).sum()
        (g,) = torch.autograd.grad(loss, table)
        if mode != "mesh2d":  # the paper layout's table is replicated over data
            g = M.all_reduce(g, BATCH_AXES, mesh)
        out["bytes"][f"grad|{mode}"] = _bytes_since(before)
        out["outputs"][f"grad|{mode}"] = g.numpy()

    # ---- a (pod 2, data 2, model 2) mesh: two batch axes, gathered inner
    # first and scattered outer first by mesh2d; lookup and table gradient
    mesh3 = M.make_debug_mesh(2, 2, pod=2)
    axes3 = M.batch_axes_for(mesh3)
    out["coords3"] = dict(mesh3.coords)
    idx3, msk3 = (L.constrain(torch.from_numpy(d[k]), P(axes3), mesh3) for k in ("idx", "mask"))
    for name, case in meta["pod_cases"].items():
        emb = emb_for(case)
        spec = emb.param_specs(axes3)["table"]
        table = L.constrain(nest(d, case["params"])["table"], spec, mesh3).clone()
        table.requires_grad_(True)
        before = M.comm_bytes()
        pooled = emb.lookup({"table": table}, idx3, msk3, mesh=mesh3, batch_axes=axes3)
        out["bytes"][f"pod|{name}"] = _bytes_since(before)
        out["outputs"][f"pod_lookup|{name}"] = pooled.detach().numpy()
        loss = R.dense_shard(pooled, axes3, mesh3, have=emb.output_axes(axes3)).sum()
        (g,) = torch.autograd.grad(loss, table)
        if case["mode"] != "mesh2d":
            g = M.all_reduce(g, axes3, mesh3)
        out["outputs"][f"pod_grad|{name}"] = g.numpy()

    # ---- the tiny DLRM: forward, loss and gradients with clipping, one step
    batch = {k: L.constrain(torch.from_numpy(d[f"dlrm_batch|{k}"]), batch_p, mesh)
             for k in ("indices", "mask", "dense", "labels")}
    for mode in meta["dlrm_modes"]:
        cfg = dlrm_cfg(meta, mode)
        ns = cfg.num_shards_for(mesh)
        specs = R.param_specs(cfg, ns, BATCH_AXES)
        params = R.shard_params(nest(d, f"dlrm{ns}"), specs, mesh)
        with torch.no_grad():
            scores = R.forward(cfg, params, batch, mesh, BATCH_AXES)
            out["outputs"][f"forward|{mode}"] = scores.numpy()
            out["outputs"][f"forward_gathered|{mode}"] = R.gather_scores(
                scores, mesh, BATCH_AXES).numpy()
        if mode not in meta["train_modes"]:
            continue
        loss, grads = R.loss_and_grads(cfg, params, batch, mesh, BATCH_AXES)
        clipped, norm = O.clip_by_global_norm(grads, meta["max_norm"], mesh, specs)
        out["outputs"][f"loss|{mode}"] = loss.numpy()
        out["outputs"][f"norm|{mode}"] = norm.numpy()
        for k, v in flat_np(clipped).items():
            out["outputs"][f"clipped|{mode}|{k}"] = v
        opt = optimizer()
        step = R.make_train_step(cfg, opt, mesh, BATCH_AXES)
        new_p, new_s, m = step(params, opt.init(params), batch)
        out["outputs"][f"step_loss|{mode}"] = m["loss"].numpy()
        for k, v in flat_np(new_p).items():
            out["outputs"][f"step_params|{mode}|{k}"] = v
        for k, v in flat_np(new_s).items():
            out["outputs"][f"step_state|{mode}|{k}"] = v

    # ---- the other recsys archs: forward, loss and gradients, one step
    arch_params = {}
    for name in meta["arch_forward"]:
        cfg = arch_cfg(meta, name)
        arch = cfg.arch
        specs = R.param_specs(cfg, cfg.num_shards_for(mesh), BATCH_AXES)
        params = arch_params[name] = R.shard_params(nest(d, f"arch|{name}"), specs, mesh)
        abatch = {k: L.constrain(v, batch_p, mesh)
                  for k, v in nest(d, f"arch_batch|{arch}").items()}
        with torch.no_grad():
            out["outputs"][f"arch_forward|{name}"] = R.forward(
                cfg, params, abatch, mesh, BATCH_AXES).numpy()
        if name not in meta["arch_train"]:
            continue
        loss, grads = R.loss_and_grads(cfg, params, abatch, mesh, BATCH_AXES)
        out["outputs"][f"arch_loss|{name}"] = loss.numpy()
        for k, v in flat_np(grads).items():
            out["outputs"][f"arch_grads|{name}|{k}"] = v
        opt = recsys_optimizer()
        new_p, new_s, m = R.make_train_step(cfg, opt, mesh, BATCH_AXES)(
            params, opt.init(params), abatch)
        out["outputs"][f"arch_step_loss|{name}"] = m["loss"].numpy()
        for k, v in flat_np(new_p).items():
            out["outputs"][f"arch_step_params|{name}|{k}"] = v
        for k, v in flat_np(new_s).items():
            out["outputs"][f"arch_step_state|{name}|{k}"] = v

    # ---- retrieval: candidates split over every axis (two_tower, queries
    # whole and split over data) and over data (mind)
    k = meta["retrieval_k"]
    tt = arch_cfg(meta, "two_tower")
    cands = L.constrain(torch.from_numpy(d["cands"]), P(mesh.axis_names, None), mesh)
    queries = nest(d, "tt_query")
    split = {key: L.constrain(v, batch_p, mesh) for key, v in queries.items()}
    mind_b = nest(d, "mind_query")
    mind_b["cand_ids"] = L.constrain(mind_b["cand_ids"], batch_p, mesh)
    for name, (vals, idx) in {
        "two_tower": R.retrieval_topk(tt, arch_params["two_tower"], queries, cands, k, mesh, ()),
        "two_tower_split": R.retrieval_topk(tt, arch_params["two_tower"], split, cands, k, mesh,
                                            BATCH_AXES),
        "mind": R.mind_retrieval(arch_cfg(meta, "mind"), arch_params["mind"], mind_b, k, mesh,
                                 BATCH_AXES),
    }.items():
        out["outputs"][f"retrieval|{name}|values"] = vals.numpy()
        out["outputs"][f"retrieval|{name}|indices"] = idx.numpy()

    # ---- the LM: sharded_vocab_embed, then decode_step under the mesh
    before = M.comm_bytes()
    out["outputs"]["vocab_embed"] = L.sharded_vocab_embed(
        L.constrain(torch.from_numpy(d["embed_table"]), P("model", None), mesh),
        L.constrain(torch.from_numpy(d["embed_tokens"]), batch_p, mesh), mesh,
        out_dtype=torch.float32).numpy()
    out["bytes"]["vocab_embed"] = _bytes_since(before)
    for name, (_, batch_axes, seq_axes, fsdp, inputs) in meta["lm_decode_cases"].items():
        batch_axes, seq_axes = tuple(batch_axes), tuple(seq_axes)
        cfg = lm_cfg(meta, fsdp)
        lm_params = R.shard_params(nest(d, "lm"), T.mesh_param_specs(cfg, mesh, BATCH_AXES), mesh)
        spec = T.cache_specs(cfg, batch_axes, seq_axes)
        cache = tuple(L.constrain(torch.from_numpy(d[f"lm_cache|{inputs}|{kv}"]), spec,
                                  mesh).contiguous() for kv in ("k", "v"))
        toks = L.constrain(torch.from_numpy(d[f"lm_tokens|{inputs}"]),
                           P(None, batch_axes or None), mesh)
        logits = []
        before = M.comm_bytes()
        with torch.no_grad():
            for i in range(meta["lm_steps"]):
                pos = torch.tensor(meta["lm_pos"] + i, dtype=torch.int32)
                lg, cache = T.decode_step(cfg, lm_params, cache, toks[i], pos, mesh,
                                          batch_axes, seq_axes, fsdp_axes=BATCH_AXES)
                logits.append(lg)
        out["bytes"][f"lm_decode|{name}"] = _bytes_since(before)
        out["outputs"][f"lm_decode|{name}|logits"] = torch.stack(logits).numpy()
        out["outputs"][f"lm_decode|{name}|k"] = cache[0].numpy()
        out["outputs"][f"lm_decode|{name}|v"] = cache[1].numpy()

    lm_tp(meta, d, mesh, mesh3, out)
    gnn(meta, d, mesh, out)

    # ---- refusals
    try:
        M.make_production_mesh()
    except ValueError as e:
        out["errors"]["production_mesh"] = str(e)
    emb = DisaggEmbedding(specs_of(meta["emb_specs"]), dim=meta["dim"], num_shards=8,
                          mode="mesh2d", replicated_fields=(2,))
    try:
        emb.lookup(local_params(emb, "emb|rep|8"), idx, msk, mesh=mesh)
    except NotImplementedError as e:
        out["errors"]["mesh2d_replicated"] = str(e)
    return out


def lm_tp_cfg(case: dict) -> T.TransformerConfig:
    moe = MOE.MoEConfig(**case["moe"]) if case["moe"] else None
    return T.TransformerConfig(**case["cfg"], moe=moe, compute_dtype=torch.float32)


def grads_of() -> O.Optimizer:
    """An optimizer whose update returns the gradients as the params."""
    return O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))


def lm_tp(meta: dict, d: dict, mesh, mesh3, out: dict) -> None:
    """The LM's tensor-, sequence- and FSDP-parallel cases on this rank:
    ``forward`` and ``prefill`` on its blocks (``mesh_param_specs``; the
    Adafactor case's prefill through its ``build_lm_cell`` serving cell
    with ``fsdp_serve``, bf16 params, which the inputs' values survive),
    ``caches_for_decode`` and ``decode_step``s from them (the same params),
    the gradients and one Adam step of
    ``make_train_step`` with ``fsdp`` and 2 microbatches, and the Adafactor
    case's train cell's step; with the bytes counted by each part."""
    from repro_torch.configs import lm_common

    meshes = {"main": mesh, "pod": mesh3}
    for name, case in meta["lm_tp_cases"].items():
        m, ba = meshes[case["mesh"]], tuple(case["batch_axes"])
        cfg = lm_tp_cfg(case)
        whole = nest(d, f"lmtp|{name}")
        params = R.shard_params(whole, T.mesh_param_specs(cfg, m, ba), m)
        toks = L.constrain(torch.from_numpy(d[f"lmtp_tokens|{name}"]), P(ba), m)
        res = out["outputs"]
        before = M.comm_bytes()
        with torch.no_grad():
            logits, aux = T.forward(cfg, params, toks, m, ba)
        out["bytes"][f"lmtp_forward|{name}"] = _bytes_since(before)
        res[f"lmtp|{name}|logits"], res[f"lmtp|{name}|aux"] = logits.numpy(), aux.numpy()
        before = M.comm_bytes()
        with torch.no_grad():
            if case["adafactor"]:  # the serving cell's step, bf16 params
                cell = lm_common.build_lm_cell(cfg, "adam", "prefill_32k", m,
                                               case["mesh"] == "pod", fsdp_serve=True)
                cparams = R.shard_params(tree_map(lambda t: t.to(torch.bfloat16), whole),
                                         cell.in_shardings[0], m)
                last, caches = cell.step_fn(cparams, toks)
            else:
                last, caches = T.prefill(cfg, params, toks, m, ba)
            res[f"lmtp|{name}|last"] = last.numpy()
            res[f"lmtp|{name}|prefill_k"], res[f"lmtp|{name}|prefill_v"] = (
                c.numpy() for c in caches)
            cache = T.caches_for_decode(cfg, caches, meta["lm_tp_max_len"], m, ba)
            dec_toks = L.constrain(torch.from_numpy(d[f"lmtp_decode_tokens|{name}"]),
                                   P(None, ba), m)
            dec = []
            for i in range(dec_toks.shape[0]):
                pos = torch.tensor(toks.shape[1] + i, dtype=torch.int32)
                lg, cache = T.decode_step(cfg, params, cache, dec_toks[i], pos, m, ba,
                                          ("model",))
                dec.append(lg)
        out["bytes"][f"lmtp_prefill|{name}"] = _bytes_since(before)
        res[f"lmtp|{name}|decode"] = torch.stack(dec).numpy()
        res[f"lmtp|{name}|decode_k"], res[f"lmtp|{name}|decode_v"] = (c.numpy() for c in cache)

        batch = {k: L.constrain(torch.from_numpy(d[f"lmtp_train|{name}|{k}"]), P(ba), m)
                 for k in ("tokens", "labels")}
        tcfg = dataclasses.replace(cfg, fsdp=True, microbatches=2)
        pspecs = T.mesh_param_specs(tcfg, m, ba)
        tparams = R.shard_params(whole, pspecs, m)
        for opt_name, opt in (("grads", grads_of()), ("adam", O.make_adam(1e-3, eps=ADAM_EPS))):
            before = M.comm_bytes()
            new_p, _, met = T.make_train_step(tcfg, opt, m, ba, pspecs)(
                tparams, opt.init(tparams), batch)
            if opt_name == "grads":
                out["bytes"][f"lmtp_train|{name}"] = _bytes_since(before)
            res[f"lmtp|{name}|{opt_name}_loss"] = met["loss"].numpy()
            for k, v in flat_np(new_p).items():
                res[f"lmtp|{name}|{opt_name}|{k}"] = v
            if opt_name == "grads":  # each block once, each replicated leaf once
                res[f"lmtp|{name}|norm"] = O.clip_by_global_norm(new_p, 1.0, m, pspecs)[1].numpy()
        if case["adafactor"]:  # the train cell's step
            cell = lm_common.build_lm_cell(cfg, "adafactor", "train_4k", m,
                                           case["mesh"] == "pod")
            cparams = R.shard_params(whole, cell.in_shardings[0], m)
            opt_state = cell.args[1]  # meta tensors: the state's global shapes
            state = R.shard_params(tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                                              opt_state), cell.in_shardings[1], m)
            new_p, _, met = cell.step_fn(cparams, state, batch)
            res[f"lmtp|{name}|adafactor_loss"] = met["loss"].numpy()
            for k, v in flat_np(new_p).items():
                res[f"lmtp|{name}|adafactor|{k}"] = v


def gnn_params(d: dict, prefix: str = "gnn_p") -> dict:
    t = nest(d, prefix)
    return {"layers": [t[f"l{i}"] for i in range(len(t) - 1)], "out": t["out"]}


def gnn(meta: dict, d: dict, mesh, out: dict) -> None:
    """The GNN's mesh paths on this rank, with the bytes each counted:
    ``forward_full_graph`` and ``make_train_step_full`` (the gradients, then
    Adam) on the rank's block of the edges, ``forward_full_graph_partitioned``
    in f32 and bf16 comm on its block of the nodes and of the
    pre-partitioned edges, and the minibatch and molecule cells (the cell's
    loss and gradients by ``gnn.loss_and_grads``, then the cell's step) on
    the rank's blocks of their batches."""
    from repro_torch.configs import graphsage_reddit as GR

    gm = meta["gnn"]
    cfg = G.GNNConfig(**gm["cfg"])
    params = gnn_params(d)
    axes = mesh.axis_names
    res = out["outputs"]
    whole = {k: torch.from_numpy(d[f"gnn_full|{k}"]) for k in ("feats", "edges", "edge_mask",
                                                                "labels")}
    b = dict(whole, edges=L.constrain(whole["edges"], P(axes, None), mesh),
             edge_mask=L.constrain(whole["edge_mask"], P(axes), mesh))
    before = M.comm_bytes()
    with torch.no_grad():
        res["gnn|fwd"] = G.forward_full_graph(cfg, params, b["feats"], b["edges"],
                                              b["edge_mask"], mesh).numpy()
    out["bytes"]["gnn_fwd"] = _bytes_since(before)
    before = M.comm_bytes()
    grads, _, met = G.make_train_step_full(cfg, grads_of(), mesh)(params, (), b)
    out["bytes"]["gnn_train"] = _bytes_since(before)
    res["gnn|full_loss"] = met["loss"].numpy()
    for k, v in flat_np(grads).items():
        res[f"gnn|full_grads|{k}"] = v
    adam = O.make_adam(1e-3)
    new_p, new_s, _ = G.make_train_step_full(cfg, adam, mesh)(params, adam.init(params), b)
    for k, v in {**flat_np(new_p), **{"state" + k: v for k, v in flat_np(new_s).items()}}.items():
        res[f"gnn|full_adam|{k}"] = v
    feats = L.constrain(whole["feats"], P(axes, None), mesh)
    ep = L.constrain(torch.from_numpy(d["gnn_part|edges"]), P(axes, None), mesh)
    mp = L.constrain(torch.from_numpy(d["gnn_part|edge_mask"]), P(axes), mesh)
    for comm, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        before = M.comm_bytes()
        with torch.no_grad():
            res[f"gnn|part|{comm}"] = G.forward_full_graph_partitioned(
                cfg, params, feats, ep, mp, mesh, comm_dtype=cdt).numpy()
        out["bytes"][f"gnn_part|{comm}"] = _bytes_since(before)

    GR.SHAPES["minibatch_lg"] = {**GR.SHAPES["minibatch_lg"], **gm["minibatch"],
                                 "fanout": tuple(gm["minibatch"]["fanout"])}
    for shape in ("minibatch_lg", "molecule"):
        cell = GR.build_cell(shape, mesh, False)
        mcfg = GR._cfg(GR.SHAPES[shape])
        mparams = gnn_params(d, f"gnn_cellp|{shape}")
        batch = {k: L.constrain(v, cell.in_shardings[2][k], mesh)
                 for k, v in nest(d, f"gnn_cell|{shape}").items()}
        if shape == "minibatch_lg":
            loss_fn = GR.minibatch_loss(mcfg, batch["labels"].shape[1], mesh, axes)
        else:
            loss_fn = GR.molecule_loss(mcfg, mesh, (AXIS_DATA,))
        loss, grads = G.loss_and_grads(loss_fn, mparams, batch, mesh, axes)
        res[f"gnn|cell_loss|{shape}"] = loss.numpy()
        for k, v in flat_np(grads).items():
            res[f"gnn|cell_grads|{shape}|{k}"] = v
        before = M.comm_bytes()
        new_p, new_s, met = cell.step_fn(mparams, adam.init(mparams), batch)
        out["bytes"][f"gnn_cell|{shape}"] = _bytes_since(before)
        res[f"gnn|cell_step_loss|{shape}"] = met["loss"].numpy()
        for k, v in {**flat_np(new_p),
                     **{"state" + k: v for k, v in flat_np(new_s).items()}}.items():
            res[f"gnn|cell_step|{shape}|{k}"] = v

    # the molecule cell where `model` does not divide a data rank's graphs:
    # MOLECULE_UNEVEN a data rank, blocks of one on the first model ranks and
    # the last ones empty (``gnn.model_block``)
    cell = GR.build_cell("molecule", mesh, False)
    mparams = gnn_params(d, "gnn_cellp|molecule")
    n = MOLECULE_UNEVEN * mesh.axis_size(AXIS_DATA)
    batch = {k: L.constrain(v[:n], cell.in_shardings[2][k], mesh)
             for k, v in nest(d, "gnn_cell|molecule").items()}
    res["gnn|uneven|block_graphs"] = np.int64(G.model_block(batch["feats"], mesh).shape[0])
    loss_fn = GR.molecule_loss(GR._cfg(GR.SHAPES["molecule"]), mesh, (AXIS_DATA,))
    loss, grads = G.loss_and_grads(loss_fn, mparams, batch, mesh, axes)
    res["gnn|uneven|loss"] = loss.numpy()
    for k, v in flat_np(grads).items():
        res[f"gnn|uneven|grads|{k}"] = v
    new_p, new_s, met = cell.step_fn(mparams, adam.init(mparams), batch)
    res["gnn|uneven|step_loss"] = met["loss"].numpy()
    for k, v in {**flat_np(new_p),
                 **{"state" + k: v for k, v in flat_np(new_s).items()}}.items():
        res[f"gnn|uneven|step|{k}"] = v


def echo_coords(rank: int, world: int, shape) -> dict:
    return dict(M.Mesh(shape, ("data", "model")).coords)


def fail_on_rank_1(rank: int, world: int) -> int:
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    M.make_debug_mesh(1, world).barrier()  # rank 0 waits for rank 1 and is killed
    return rank


def sleep(rank: int, world: int, seconds: float) -> None:
    import time
    time.sleep(seconds)


def restore_rank(rank: int, world: int, ckpt_dir: str, shape) -> dict:
    """A one-process checkpoint (step 1) restored under a mesh of ``shape``:
    the params by the specs recorded at save, the optimizer state by
    ``sharding_rules``; then saved again from the mesh as step 2."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.optim import sharding_rules as SR

    torch.set_num_threads(1)
    mesh = M.Mesh(shape, ("data", "model"))
    cfg = R.RecsysConfig(name="t", arch="dlrm", tables=tuple(specs_of(
        [("big", 4000, 4, "sum"), ("mid", 1000, 1, "sum")])), embed_dim=8, n_dense=3,
        bottom_mlp=(8,), mlp=(8,))
    ns = cfg.num_shards_for(mesh)
    pshapes = R.abstract_params(cfg, ns)
    opt = optimizer()
    state_shapes = opt.init(pshapes)
    state_specs = SR.composite_state_specs([("emb", "rowwise"), (".*", "adam")],
                                           R.param_specs(cfg, ns), pshapes)
    mgr = CheckpointManager(ckpt_dir)
    (params, state), extra = mgr.restore((pshapes, state_shapes), step=1, mesh=mesh,
                                         specs=(None, state_specs), device="cpu")
    mgr.save(2, (params, state), specs=(R.param_specs(cfg, ns), state_specs), extra=extra,
             blocking=True, mesh=mesh)
    return {"coords": dict(mesh.coords), "params": flat_np(params), "state": flat_np(state)}


def compress_psum_rank(rank: int, world: int, x: np.ndarray) -> dict:
    """``compress_psum`` over the one axis of a (1, world) mesh of rank's
    share ``x * (rank + 1)``, and the bytes it counted."""
    from repro_torch.optim import grad_compress as GC

    mesh = M.make_debug_mesh(1, world)
    before = M.comm_bytes()
    got = GC.compress_psum(torch.from_numpy(x) * (rank + 1), "model", mesh)
    return {"sum": got.numpy(), "bytes": _bytes_since(before)}
