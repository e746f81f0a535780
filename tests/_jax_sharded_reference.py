"""The reference's side of tests/test_torch_sharded.py, run as a script:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_sharded_reference.py inputs.npz outputs.npz

Reads the inputs the test wrote (a .npz whose ``meta`` entry is the JSON case
list) and runs the JAX package's sharded paths once under its (2, 4) mesh:
every lookup case (its whole output, and the collective bytes and the
FLOPs ``launch.hlo_analysis.analyze`` reads from its compiled HLO), ``lookup_rows``,
``chunked_lookup``, ``cache_partition_spec``, ``gather_rows``, ``jax.grad`` of the lookup (also under a (2, 2, 2) mesh
with two batch axes), ``R.forward``, the loss and its
gradients (global norm clipping) and one ``make_train_step``, on the
test's params; then the other recsys archs' forward, loss, gradients and one
step, and ``retrieval_topk`` and ``mind_retrieval``; the LM's
``sharded_vocab_embed`` and ``transformer.decode_step`` under the mesh, a
few steps of each decode case, its params placed by the serving cell's
``param_specs`` (FSDP over data where the case asks), with the collective
bytes and FLOPs of its compiled step.  Outputs are the whole logical arrays, keyed
as the port's side keys its blocks.  With a third argument ``lm_tp`` it runs
only the LM's tensor-, sequence- and FSDP-parallel cases instead (``lm_tp``:
``forward``, ``prefill`` and ``decode_step`` from its caches, and
``make_train_step`` with the gradients, Adam and Adafactor), so the test
runs both parts at once.  The main part ends with the GNN (``gnn``):
the edge-sharded ``forward_full_graph`` and ``make_train_step_full``,
``forward_full_graph_partitioned`` in f32 and bf16 comm, and the
minibatch and molecule cells' steps, each under the mesh and on one
device."""
from __future__ import annotations

import dataclasses
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.compat import make_mesh
from repro.core.embedding import (DisaggEmbedding, make_cache_from_table,
                                  make_hash_cache_from_table)
from repro.core.lookup_engine import chunked_lookup
from repro.configs import graphsage_reddit as JGR
from repro.core.sharding import TableSpec
from repro.hotcache.table import cache_partition_spec
from repro.launch.hlo_analysis import analyze
from repro.models import gnn as JG
from repro.models import layers as JL
from repro.models import recsys as R
from repro.models import transformer as JT
from repro.models.moe import MoEConfig
from repro.optim import optimizers as O

BATCH_AXES = ("data",)
ADAM_EPS = 1e-3  # the LM train step's Adam (tests/_torch_sharded_ranks.py says why)


def specs_of(rows):
    return [TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in rows]


def nest(flat: dict, prefix: str) -> dict:
    """``{"a|b": x}`` entries under ``prefix|`` as nested dicts of arrays; a
    node whose keys are all indices (``attn|0|wq``) is a list."""
    out: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "|"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("|")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def flat_np(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def placed(tree, specs, mesh):
    """``tree`` put on the mesh by ``specs`` (a tree of PartitionSpec), as a
    cell's ``in_shardings`` place its arguments."""
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
                        is_leaf=lambda x: isinstance(x, P))


_IOTA_GROUPS = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")


def explicit_groups(hlo_text: str) -> str:
    """The HLO text with every iota replica-group list (``[4,2]<=[2,4]T(1,0)``)
    written out as ``{{0,4},{1,5},...}``: ``analyze`` reads a group's size
    from the untransposed iota form only and takes a transposed one (the
    groups over `data` of a (data, model) mesh) for the whole mesh."""
    def expand(m):
        ids = np.arange(int(np.prod([int(x) for x in m.group(3).split(",")])))
        ids = ids.reshape([int(x) for x in m.group(3).split(",")])
        if m.group(4):
            ids = ids.transpose([int(x) for x in m.group(4).split(",")])
        rows = ids.reshape(int(m.group(1)), int(m.group(2)))
        return "replica_groups={" + ",".join("{" + ",".join(map(str, r)) + "}"
                                             for r in rows) + "}"
    return _IOTA_GROUPS.sub(expand, hlo_text)


def compiled(fn, *args):
    """(outputs, analyze(...) of the compiled HLO) of ``jax.jit(fn)(*args)``."""
    c = jax.jit(fn).lower(*args).compile()
    return c(*args), analyze(c.as_text(), 8)


def main(inputs_path: str, outputs_path: str, part: str = "main") -> None:
    d = dict(np.load(inputs_path))
    meta = json.loads(str(d["meta"]))
    mesh = make_mesh(tuple(meta["mesh"]), ("data", "model"))
    if part == "lm_tp":
        np.savez(outputs_path, **lm_tp(meta, d, mesh))
        return
    idx, msk = jnp.asarray(d["idx"]), jnp.asarray(d["mask"])
    out: dict = {}

    def emb_for(case):
        return DisaggEmbedding(specs_of(meta["emb_specs"]), dim=meta["dim"],
                               num_shards=case["num_shards"], mode=case["mode"],
                               replicated_fields=tuple(case["replicated"]),
                               comm_dtype=jnp.bfloat16 if case["comm"] == "bf16" else None)

    for name, case in meta["lookup_cases"].items():
        emb = emb_for(case)
        params = nest(d, case["params"])
        cache = None
        if case["cache"] == "flat":
            cache = make_cache_from_table(emb, params, d["hot"], meta["flat_slots"], mesh=mesh)
        elif case["cache"] == "hash":
            cache = make_hash_cache_from_table(emb, params, d["hot"], meta["hash_slots"],
                                               mesh=mesh)
        nc = case["num_chunks"]
        got, terms = compiled(
            lambda p, i, m, c, emb=emb, nc=nc: emb.lookup(p, i, m, mesh=mesh, cache=c,
                                                          batch_axes=BATCH_AXES, num_chunks=nc),
            params, idx, msk, cache)
        out[f"lookup|{name}"] = np.asarray(got)
        out[f"hlo_bytes|{name}"] = np.float64(terms.collective_bytes_per_device)
        out[f"hlo_flops|{name}"] = np.float64(terms.flops_per_device)
        for op, n in terms.collective_counts.items():
            out[f"hlo_calls|{name}|{op}"] = np.int64(n)
    case = meta["lookup_cases"]["hierarchical"]
    emb, params = emb_for(case), nest(d, case["params"])
    got, terms = compiled(lambda p, i, m: emb.lookup_rows(p, i, m, mesh=mesh), params, idx, msk)
    out["lookup_rows"] = np.asarray(got)
    out["hlo_bytes|lookup_rows"] = np.float64(terms.collective_bytes_per_device)
    out["hlo_flops|lookup_rows"] = np.float64(terms.flops_per_device)
    out["chunked_lookup"] = np.asarray(jax.jit(lambda p, i, m: chunked_lookup(
        emb, p, i, m, mesh, 2, batch_axes=BATCH_AXES))(params, idx, msk))
    spec = cache_partition_spec()
    out["cache_partition_spec"] = np.array(json.dumps(
        {f: list(getattr(spec, f)) for f in ("keys", "rows", "freq")}))
    got, terms = compiled(lambda p, r: emb.gather_rows(p, r, mesh=mesh), params,
                          jnp.asarray(d["row_ids"]))
    out["gather_rows"] = np.asarray(got)
    out["hlo_bytes|gather_rows"] = np.float64(terms.collective_bytes_per_device)
    out["hlo_flops|gather_rows"] = np.float64(terms.flops_per_device)

    for mode in meta["grad_modes"]:
        case = meta["lookup_cases"][mode]
        emb, params = emb_for(case), nest(d, case["params"])
        g = jax.jit(jax.grad(lambda p, emb=emb: emb.lookup(p, idx, msk, mesh=mesh).sum()))(params)
        out[f"grad|{mode}"] = np.asarray(g["table"])

    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
    axes3 = ("pod", "data")
    for name, case in meta["pod_cases"].items():
        emb, params = emb_for(case), nest(d, case["params"])
        got, terms = compiled(
            lambda p, i, m, emb=emb: emb.lookup(p, i, m, mesh=mesh3, batch_axes=axes3),
            params, idx, msk)
        out[f"pod_lookup|{name}"] = np.asarray(got)
        out[f"hlo_bytes|pod|{name}"] = np.float64(terms.collective_bytes_per_device)
        out[f"hlo_flops|pod|{name}"] = np.float64(terms.flops_per_device)
        g = jax.jit(jax.grad(lambda p, emb=emb: emb.lookup(
            p, idx, msk, mesh=mesh3, batch_axes=axes3).sum()))(params)
        out[f"pod_grad|{name}"] = np.asarray(g["table"])

    batch = {k: jnp.asarray(d[f"dlrm_batch|{k}"]) for k in ("indices", "mask", "dense", "labels")}
    for mode in meta["dlrm_modes"]:
        cfg = R.RecsysConfig(name="t", arch="dlrm", tables=tuple(specs_of(meta["dlrm_specs"])),
                             embed_dim=meta["dim"], n_dense=meta["n_dense"],
                             bottom_mlp=tuple(meta["bottom_mlp"]), mlp=tuple(meta["mlp"]),
                             mode=mode)
        params = nest(d, f"dlrm{cfg.num_shards_for(mesh)}")
        out[f"forward|{mode}"] = np.asarray(
            jax.jit(lambda p, b, cfg=cfg: R.forward(cfg, p, b, mesh, BATCH_AXES))(params, batch))
        if mode not in meta["train_modes"]:
            continue

        def loss_fn(p, cfg=cfg):
            return R.bce_loss(R.forward(cfg, p, batch, mesh, BATCH_AXES), batch["labels"])

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        clipped, norm = O.clip_by_global_norm(grads, meta["max_norm"])
        out[f"loss|{mode}"] = np.asarray(loss)
        out[f"norm|{mode}"] = np.asarray(norm)
        for k, v in flat_np(clipped).items():
            out[f"clipped|{mode}|{k}"] = v
        opt = O.make_composite([("emb", O.make_rowwise_adagrad(0.05)),
                                (".*", O.make_adam(1e-3))])
        step = jax.jit(R.make_train_step(cfg, opt, mesh, BATCH_AXES))
        new_p, new_s, m = step(params, opt.init(params), batch)
        out[f"step_loss|{mode}"] = np.asarray(m["loss"])
        for k, v in flat_np(new_p).items():
            out[f"step_params|{mode}|{k}"] = v
        for k, v in flat_np(new_s).items():
            out[f"step_state|{mode}|{k}"] = v
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    recsys_opt = O.make_composite([("emb|wide", O.make_rowwise_adagrad(0.05)),
                                   (".*", O.make_adam(1e-3))])
    arch_params = {}
    for name in meta["arch_forward"]:
        cfg = arch_cfg(meta, name)
        params = arch_params[name] = nest(d, f"arch|{name}")
        abatch = nest(d, f"arch_batch|{cfg.arch}")
        out[f"arch_forward|{name}"] = np.asarray(jax.jit(
            lambda p, b, cfg=cfg: R.forward(cfg, p, b, mesh, BATCH_AXES))(params, abatch))
        if name not in meta["arch_train"]:
            continue
        grads, _, m = jax.jit(R.make_train_step(cfg, grads_of, mesh, BATCH_AXES))(
            params, (), abatch)
        out[f"arch_loss|{name}"] = np.asarray(m["loss"])
        for k, v in flat_np(grads).items():
            out[f"arch_grads|{name}|{k}"] = v
        new_p, new_s, m = jax.jit(R.make_train_step(cfg, recsys_opt, mesh, BATCH_AXES))(
            params, recsys_opt.init(params), abatch)
        out[f"arch_step_loss|{name}"] = np.asarray(m["loss"])
        for k, v in flat_np(new_p).items():
            out[f"arch_step_params|{name}|{k}"] = v
        for k, v in flat_np(new_s).items():
            out[f"arch_step_state|{name}|{k}"] = v

    k = meta["retrieval_k"]
    tt, mind = arch_cfg(meta, "two_tower"), arch_cfg(meta, "mind")
    queries, mind_b = nest(d, "tt_query"), nest(d, "mind_query")
    cands = jnp.asarray(d["cands"])
    for name, fn, args in (
        ("two_tower", lambda p, b, c: R.retrieval_topk(tt, p, b, c, k, mesh, ()),
         (arch_params["two_tower"], queries, cands)),
        ("two_tower_split", lambda p, b, c: R.retrieval_topk(tt, p, b, c, k, mesh, BATCH_AXES),
         (arch_params["two_tower"], queries, cands)),
        ("mind", lambda p, b: R.mind_retrieval(mind, p, b, k, mesh, BATCH_AXES),
         (arch_params["mind"], mind_b)),
    ):
        vals, idx = jax.jit(fn)(*args)
        out[f"retrieval|{name}|values"] = np.asarray(vals)
        out[f"retrieval|{name}|indices"] = np.asarray(idx)

    out["vocab_embed"] = np.asarray(jax.jit(lambda t, tok: JL.sharded_vocab_embed(
        t, tok, mesh, BATCH_AXES, out_dtype=jnp.float32))(jnp.asarray(d["embed_table"]),
                                                          jnp.asarray(d["embed_tokens"])))
    base = JT.TransformerConfig(**meta["lm"], moe=MoEConfig(**meta["lm_moe"]),
                                compute_dtype=jnp.float32, remat_groups=1)
    for name, (b, batch_axes, seq_axes, fsdp, inputs) in meta["lm_decode_cases"].items():
        ba, sa = tuple(batch_axes), tuple(seq_axes)
        # the serving cell's layout: param_specs with FSDP over the batch axes
        cfg = dataclasses.replace(base, fsdp=fsdp)
        pspecs = JT.param_specs(cfg, mesh, fsdp, BATCH_AXES)
        step = jax.jit(lambda p, c, t, pos, cfg=cfg, ba=ba, sa=sa:
                       JT.decode_step(cfg, p, c, t, pos, mesh, ba, sa))
        cache = (jnp.asarray(d[f"lm_cache|{inputs}|k"]), jnp.asarray(d[f"lm_cache|{inputs}|v"]))
        lm_params = placed(nest(d, "lm"), pspecs, mesh)
        logits = []
        for i, toks in enumerate(d[f"lm_tokens|{inputs}"]):
            lg, cache = step(lm_params, cache, jnp.asarray(toks),
                             jnp.asarray(meta["lm_pos"] + i, jnp.int32))
            logits.append(np.asarray(lg))
        out[f"lm_decode|{name}|logits"] = np.stack(logits)
        out[f"lm_decode|{name}|k"] = np.asarray(cache[0])
        out[f"lm_decode|{name}|v"] = np.asarray(cache[1])
        # the same step at lm_hlo_d_head compiled from its arguments' shapes
        # and layouts (the decode cell's), for its collective bytes and FLOPs
        hcfg = dataclasses.replace(cfg, d_head=meta["lm_hlo_d_head"])
        cshape = (hcfg.n_layers, b, d[f"lm_cache|{inputs}|k"].shape[2], hcfg.n_kv_heads,
                  hcfg.d_head)

        def sds(shape, dtype, spec):
            return jax.ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(mesh, spec))

        args = (jax.tree.map(lambda x, s: sds(x.shape, x.dtype, s), JT.abstract_params(
                    hcfg, mesh), JT.param_specs(hcfg, mesh, fsdp, BATCH_AXES),
                    is_leaf=lambda x: isinstance(x, P)),
                (sds(cshape, jnp.float32, JT.cache_specs(hcfg, ba, sa)),) * 2,
                sds((b,), jnp.int32, P(ba or None)), sds((), jnp.int32, P()))
        text = jax.jit(lambda p, c, t, pos, cfg=hcfg, ba=ba, sa=sa: JT.decode_step(
            cfg, p, c, t, pos, mesh, ba, sa)).lower(*args).compile().as_text()
        terms = analyze(explicit_groups(text), 8)
        n = len(d[f"lm_tokens|{inputs}"])  # the steps, each this program
        out[f"hlo_bytes|lm_decode|{name}"] = np.float64(n * terms.collective_bytes_per_device)
        out[f"hlo_flops|lm_decode|{name}"] = np.float64(n * terms.flops_per_device)
    out.update(gnn(meta, d, mesh))
    np.savez(outputs_path, **out)


def lm_tp_cfg(case: dict) -> JT.TransformerConfig:
    moe = MoEConfig(**case["moe"]) if case["moe"] else None
    return JT.TransformerConfig(**case["cfg"], moe=moe, compute_dtype=jnp.float32)


def lm_tp(meta: dict, d: dict, mesh) -> dict:
    """Each LM case under its mesh: ``forward``'s logits and aux,
    ``prefill``'s last logits and caches, the caches padded to the decode
    length and ``decode_step`` from them (batch over the batch axes,
    positions over model, as ``build_lm_cell`` lays out B > 1), then one
    ``make_train_step`` with ``fsdp`` and 2 microbatches whose optimizer
    returns the gradients, Adam's update of them (the step with Adam), and,
    where the case asks, one step with Adafactor at the config's own
    microbatches."""
    meshes = {"main": mesh, "pod": make_mesh((2, 2, 2), ("pod", "data", "model"))}
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    out: dict = {}
    for name, case in meta["lm_tp_cases"].items():
        m, ba = meshes[case["mesh"]], tuple(case["batch_axes"])
        cfg = lm_tp_cfg(case)
        params = nest(d, f"lmtp|{name}")
        toks = jnp.asarray(d[f"lmtp_tokens|{name}"])
        # prefill is forward with its caches, keeping the last position
        logits, aux, (k, v) = jax.jit(lambda p, t: JT.forward(cfg, p, t, m, ba, True))(
            params, toks)
        out[f"lmtp|{name}|logits"], out[f"lmtp|{name}|aux"] = np.asarray(logits), np.asarray(aux)
        out[f"lmtp|{name}|last"] = np.asarray(logits[:, -1])
        out[f"lmtp|{name}|prefill_k"], out[f"lmtp|{name}|prefill_v"] = np.asarray(k), np.asarray(v)
        pad = ((0, 0), (0, 0), (0, meta["lm_tp_max_len"] - toks.shape[1]), (0, 0), (0, 0))
        cache = (jnp.pad(k, pad), jnp.pad(v, pad))
        step = jax.jit(lambda p, c, t, pos: JT.decode_step(cfg, p, c, t, pos, m, ba, ("model",)))
        dparams = placed(params, JT.param_specs(cfg, m, True, ba), m)  # the decode cell's
        dec = []
        for i, t in enumerate(d[f"lmtp_decode_tokens|{name}"]):
            lg, cache = step(dparams, cache, jnp.asarray(t), jnp.asarray(toks.shape[1] + i, jnp.int32))
            dec.append(np.asarray(lg))
        out[f"lmtp|{name}|decode"] = np.stack(dec)
        out[f"lmtp|{name}|decode_k"], out[f"lmtp|{name}|decode_v"] = map(np.asarray, cache)
        batch = {k_: jnp.asarray(d[f"lmtp_train|{name}|{k_}"]) for k_ in ("tokens", "labels")}
        tcfg = dataclasses.replace(cfg, fsdp=True, microbatches=2)
        pspecs = JT.param_specs(tcfg, m, True, ba)
        grads, _, met = jax.jit(JT.make_train_step(tcfg, grads_of, m, ba, pspecs))(
            params, (), batch)
        # the step is its gradients, then the optimizer's update of them
        adam = O.make_adam(1e-3, eps=ADAM_EPS)
        new_p, _ = jax.jit(adam.update)(grads, adam.init(params), params)
        for opt_name, tree in (("grads", grads), ("adam", new_p)):
            out[f"lmtp|{name}|{opt_name}_loss"] = np.asarray(met["loss"])
            for key, val in flat_np(tree).items():
                out[f"lmtp|{name}|{opt_name}|{key}"] = val
        out[f"lmtp|{name}|norm"] = np.asarray(jax.jit(
            lambda g: O.clip_by_global_norm(g, 1.0)[1])(grads))
        if case["adafactor"]:
            opt = O.make_adafactor(1e-2)
            acfg = dataclasses.replace(cfg, fsdp=True)
            new_p, _, met = jax.jit(JT.make_train_step(
                acfg, opt, m, ba, JT.param_specs(acfg, m, True, ba)))(params, opt.init(params), batch)
            out[f"lmtp|{name}|adafactor_loss"] = np.asarray(met["loss"])
            for key, val in flat_np(new_p).items():
                out[f"lmtp|{name}|adafactor|{key}"] = val
    return out


def gnn_params(d: dict) -> dict:
    t = nest(d, "gnn_p")
    return {"layers": [t[f"l{i}"] for i in range(len(t) - 1)], "out": t["out"]}


def gnn(meta: dict, d: dict, mesh) -> dict:
    """The GNN's mesh paths and their one-device runs.  Full graph: the
    edge-sharded ``forward_full_graph``, and ``make_train_step_full`` with
    an optimizer that returns the gradients and with Adam; the partitioned
    forward in f32 and bf16 comm (pre-partitioned edges).  The minibatch
    cell (``minibatch_lg`` at the test's widths: one block of 4 targets a
    device) and the molecule cell (published shape): the loss and gradients
    of the cell's loss and one step of the cell, with the batch laid out by
    the cell's in_shardings; on one device the same steps on whole arrays
    (the molecule cell built on a 1x1 mesh).  Compiled collective bytes of
    each mesh program."""
    gm = meta["gnn"]
    cfg = JG.GNNConfig(**gm["cfg"])
    params = gnn_params(d)
    out: dict = {}
    grads_of = O.Optimizer(init=lambda p: (), update=lambda g, s, p: (g, s))
    b = {k: jnp.asarray(d[f"gnn_full|{k}"]) for k in ("feats", "edges", "edge_mask", "labels")}
    got, terms = compiled(lambda p, f, e, m: JG.forward_full_graph(cfg, p, f, e, m, mesh),
                          params, b["feats"], b["edges"], b["edge_mask"])
    out["gnn|fwd|mesh"] = np.asarray(got)
    out["hlo_bytes|gnn_fwd"] = np.float64(terms.collective_bytes_per_device)
    out["hlo_flops|gnn_fwd"] = np.float64(terms.flops_per_device)
    out["gnn|fwd|one"] = np.asarray(jax.jit(lambda p, f, e, m: JG.forward_full_graph(
        cfg, p, f, e, m, None))(params, b["feats"], b["edges"], b["edge_mask"]))
    adam = O.make_adam(1e-3)
    for where, m in (("mesh", mesh), ("one", None)):
        (grads, _, met), terms = compiled(JG.make_train_step_full(cfg, grads_of, m), params, (), b)
        out[f"gnn|full_loss|{where}"] = np.asarray(met["loss"])
        for k, v in flat_np(grads).items():
            out[f"gnn|full_grads|{where}|{k}"] = v
        if m is not None:
            out["hlo_bytes|gnn_train"] = np.float64(terms.collective_bytes_per_device)
            out["hlo_flops|gnn_train"] = np.float64(terms.flops_per_device)
        new_p, new_s, _ = jax.jit(JG.make_train_step_full(cfg, adam, m))(
            params, adam.init(params), b)
        for k, v in {**flat_np(new_p), **{"state" + k: v for k, v in flat_np(new_s).items()}
                     }.items():
            out[f"gnn|full_adam|{where}|{k}"] = v
    ep, mp = jnp.asarray(d["gnn_part|edges"]), jnp.asarray(d["gnn_part|edge_mask"])
    for comm, cdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        got, terms = compiled(lambda p, f, e, m, cdt=cdt: JG.forward_full_graph_partitioned(
            cfg, p, f, e, m, mesh, comm_dtype=cdt), params, b["feats"], ep, mp)
        out[f"gnn|part|{comm}"] = np.asarray(got)
        out[f"hlo_bytes|gnn_part|{comm}"] = np.float64(terms.collective_bytes_per_device)
        out[f"hlo_flops|gnn_part|{comm}"] = np.float64(terms.flops_per_device)

    JGR.SHAPES["minibatch_lg"] = {**JGR.SHAPES["minibatch_lg"], **gm["minibatch"],
                                  "fanout": tuple(gm["minibatch"]["fanout"])}
    mesh11 = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for shape in ("minibatch_lg", "molecule"):
        cell = JGR.build_cell(shape, mesh, False)
        mcfg = JGR._cfg(JGR.SHAPES[shape])
        mb = nest(d, f"gnn_cell|{shape}")
        mparams = gnn_params({k.replace(f"gnn_cellp|{shape}", "gnn_p"): v for k, v in d.items()
                              if k.startswith(f"gnn_cellp|{shape}|")})
        if shape == "minibatch_lg":
            tgt = mb["labels"].shape[1]

            def loss_fn(p, batch, m, cfg=mcfg, tgt=tgt):
                logits = jax.vmap(lambda f, e1, m1, e2, m2: JG.forward_minibatch(
                    cfg, p, f, [e1, e2], [m1, m2], tgt))(
                    batch["feats"], batch["edges1"], batch["mask1"], batch["edges2"],
                    batch["mask2"])
                return JG.node_ce_loss(logits.reshape(-1, cfg.n_classes),
                                       batch["labels"].reshape(-1))
        else:
            def loss_fn(p, batch, m, cfg=mcfg):
                o = JG.forward_molecule(cfg, p, batch["feats"], batch["edges"],
                                        batch["edge_mask"], m, ("data",))[:, 0]
                return jnp.mean((o - batch["labels"]) ** 2)
        for where in ("mesh", "one"):
            if where == "mesh":
                batch = {k: jax.device_put(v, NamedSharding(mesh, cell.in_shardings[2][k]))
                         for k, v in mb.items()}
                step, m = cell.step_fn, mesh
            else:
                batch = mb
                one = JGR.build_cell(shape, mesh11, False) if shape == "molecule" else cell
                step, m = one.step_fn, (mesh11 if shape == "molecule" else None)
            loss, grads = jax.jit(jax.value_and_grad(lambda p, bb, m=m: loss_fn(p, bb, m)))(
                mparams, batch)
            out[f"gnn|cell_loss|{shape}|{where}"] = np.asarray(loss)
            for k, v in flat_np(grads).items():
                out[f"gnn|cell_grads|{shape}|{where}|{k}"] = v
            (new_p, new_s, met), terms = compiled(step, mparams, adam.init(mparams), batch)
            out[f"gnn|cell_step_loss|{shape}|{where}"] = np.asarray(met["loss"])
            for k, v in {**flat_np(new_p),
                         **{"state" + k: v for k, v in flat_np(new_s).items()}}.items():
                out[f"gnn|cell_step|{shape}|{where}|{k}"] = v
            if where == "mesh":
                out[f"hlo_bytes|gnn_cell|{shape}"] = np.float64(terms.collective_bytes_per_device)
                out[f"hlo_flops|gnn_cell|{shape}"] = np.float64(terms.flops_per_device)
    return out


def arch_cfg(meta: dict, name: str) -> R.RecsysConfig:
    case = meta["arch_cases"][name]
    kw = dict(meta["arch_specs"][case["arch"]])
    tables = tuple(specs_of(kw.pop("tables")))
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    return R.RecsysConfig(name=name, tables=tables, embed_dim=meta["dim"], mode=case["mode"],
                          **kw, **case["over"])


if __name__ == "__main__":
    main(*sys.argv[1:])
