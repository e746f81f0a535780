"""repro_torch's dry run (``launch.dryrun``, ``launch.hlo_analysis``, the meta
route of the kernel entry points and ``launch.mesh.DryMesh``), on the CPU.

Covered: the trace's FLOPs and bytes on small programs counted by hand (a
matmul chain, a bmm, views, a gather) and its peak live bytes over a
forward and backward; ``RooflineTerms`` against the reference's; every
kernel entry point on meta against its plain version's output shapes and
dtypes on the CPU, each launch and its work against the formula written
here; tensors on two devices refused; a ``DryMesh``'s collectives against
the ring model, their refusal of other tensors and a real mesh's of meta;
``run_cell`` for every registry arch at every shape on both production
meshes (the LMs cut to 2 layers by replacing their config in the
registry), its record's keys against the reference's ``run_cell``'s; each
rank's argument bytes of every LM decode cell at full depth, under 80 GB;
and two ranks' terms equal through the CLI.
"""
import ast
import dataclasses
import functools
import json
import math
from pathlib import Path

import pytest
import torch

from repro.launch import hlo_analysis as JH
from repro_torch import configs
from repro_torch.configs import lm_common as LC
from repro_torch.hotcache import kernels as HK
from repro_torch.hotcache import ref as HREF
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import mesh as M
from repro_torch.prefetch import kernels as PK
from repro_torch.prefetch import ref as PREF

ROOT = Path(__file__).resolve().parent.parent
LM_CUT_LAYERS = 2
F32, BF16 = torch.float32, torch.bfloat16


def meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def cpu(*shape, dtype=F32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def ids(n, vocab, device="cpu"):
    return torch.randint(0, vocab, (n,), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).to(device)


def trace(fn):
    with H.Trace() as tr:
        out = fn()
    return tr, out


# ------------------------------------------------------------ the trace


@pytest.mark.parametrize("case", ["matmul_chain", "bmm_bf16", "views", "gather",
                                  "host_copy_and_cast"])
def test_trace_counts_by_hand(case):
    if case == "matmul_chain":
        a, b, c = meta(8, 16), meta(16, 32), meta(32, 4)
        tr, _ = trace(lambda: a @ b @ c)
        flops = {"f32": 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4}
        mem = (8 * 16 + 16 * 32 + 8 * 32) * 4 + (8 * 32 + 32 * 4 + 8 * 4) * 4
    elif case == "bmm_bf16":
        a, b = meta(2, 8, 16, dtype=BF16), meta(2, 16, 4, dtype=BF16)
        tr, _ = trace(lambda: torch.bmm(a, b))
        flops = {"bf16": 2 * 2 * 8 * 4 * 16}
        mem = (2 * 8 * 16 + 2 * 16 * 4 + 2 * 8 * 4) * 2
    elif case == "views":
        x = meta(4, 6, 8)
        tr, _ = trace(lambda: (x.view(24, 8), x.transpose(0, 1), x[1:], x.reshape(4, 48),
                               x.detach(), torch.empty_like(x)))
        flops, mem = {}, 0
    elif case == "gather":  # a gather counts its whole operand, as the reference's
        table, idx = meta(100, 8), torch.empty(5, dtype=torch.int64, device="meta")
        tr, _ = trace(lambda: torch.index_select(table, 0, idx))
        flops, mem = {}, 100 * 8 * 4 + 5 * 8 + 5 * 8 * 4
    else:  # a copy from the host is no HBM traffic; a cast on the device is
        host, x = torch.ones(16), meta(16)
        tr, _ = trace(lambda: (host.to("meta"), meta(16).copy_(host), x.to(BF16)))
        flops, mem = {}, 16 * 4 + 16 * 2
    assert tr.flops == {cls: float(flops.get(cls, 0)) for cls in ("bf16", "tf32", "f32")}
    assert tr.mem_bytes == mem
    assert tr.kernels == {} and tr.collectives == {}


def test_peak_live_bytes_of_a_forward_and_backward():
    """h = a @ b, loss = h.sum(), dloss/da: at the peak h, the loss, its
    seed gradient and da are alive; afterwards the seed is freed."""
    a, b = meta(64, 32).requires_grad_(True), meta(32, 16)
    with H.Trace() as tr:
        h = a @ b
        loss = h.sum()
        (da,) = torch.autograd.grad(loss, a)
    assert tr.peak_bytes == 64 * 16 * 4 + 4 + 4 + 64 * 32 * 4
    assert tr.live_bytes == 64 * 16 * 4 + 4 + 64 * 32 * 4
    del h, loss
    assert tr.live_bytes == 64 * 32 * 4 and tr.peak_bytes == 64 * 16 * 4 + 8 + 64 * 32 * 4
    assert da.shape == a.shape


@pytest.mark.parametrize("case", ["k6_output_and_lse", "k1_backward", "dry_all_gather"])
def test_peak_counts_what_empty_allocates(case):
    """A wrapper's outputs and a collective's result are made by ``empty``
    and are live storage: K6's output and logsumexp, kept for K6'; K1''s
    dense [num_rows, D] f32 gradient; a DryMesh all-gather's result."""
    from repro_torch.kernels import embedding_bag as K1

    if case == "k6_output_and_lse":
        B, S, Hq, Hkv, dh = 2, 16, 4, 2, 16
        q = meta(B, S, Hq, dh).requires_grad_(True)
        k, v = meta(B, S, Hkv, dh), meta(B, S, Hkv, dh)
        with H.Trace() as tr:
            out = ops.flash_attention(q, k, v, True)
        want = B * S * Hq * dh * 4 + B * Hq * S * 4
    elif case == "k1_backward":
        V, D_, bags, nnz = 100, 8, 6, 3
        grad_out, slots, w = meta(bags, D_), meta(bags * nnz, dtype=torch.int32), meta(bags * nnz)
        with H.Trace() as tr:
            out = K1.embedding_bag_backward(grad_out, slots, w, V)
        want = V * D_ * 4
    else:
        mesh = M.DryMesh((2, 4), ("data", "model"))
        x = meta(8, 3)
        with H.Trace() as tr:
            out = M.all_gather(x, "model", mesh)
        want = 4 * 8 * 3 * 4
    assert tr.peak_bytes == tr.live_bytes == want
    del out
    assert tr.live_bytes == 0 and tr.peak_bytes == want


def test_roofline_terms_match_the_reference():
    names = [f.name for f in dataclasses.fields(H.RooflineTerms)]
    assert names == [f.name for f in dataclasses.fields(JH.RooflineTerms)]
    vals = dict(compute_s=1.0, memory_s=3.0, collective_s=2.0, flops_per_device=4.0,
                bytes_per_device=5.0, collective_bytes_per_device=6.0,
                collective_counts={"all-reduce": 2})
    got, want = H.RooflineTerms(**vals), JH.RooflineTerms(**vals)
    assert got.as_dict() == want.as_dict()
    assert (got.dominant, got.bound_s) == (want.dominant, want.bound_s) == ("memory", 3.0)


def test_analyze_takes_each_class_at_its_peak():
    tr = H.Trace()
    tr.flops = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
    tr.mem_bytes = 3.35e12
    tr.on_collective("all_reduce", 450e9, 0, tuple(range(8)))  # one node: NVLink
    tr.on_collective("all_gather", 50e9, 0, (0, 8))  # two nodes: the network
    terms = H.analyze(tr)
    assert terms.compute_s == pytest.approx(3.0) and terms.memory_s == pytest.approx(1.0)
    assert terms.collective_s == pytest.approx(2.0)
    assert terms.collective_counts == {"all-reduce": 1, "all-gather": 1}
    assert terms.dominant == "compute"


# --------------------------------------------- the kernels' meta route


def _k1(masked):
    N, nb, V, D = 24, 6, 50, 8
    want = ref.embedding_bag_ref(cpu(V, D), ids(N, V), torch.ones(N), nb, masked=masked)
    tr, got = trace(lambda: ops.embedding_bag(meta(V, D), ids(N, V, "meta"), meta(N), nb,
                                              masked=masked))
    names = {"embedding_bag": 1, **({"embedding_bag_masked": 1} if masked else {})}
    return tr, got, want, names, {"embedding_bag": (N * (8 + D * 4) + nb * D * 4,
                                                    {"f32": 2 * N * D})}


def _k1_backward():
    N, nb, V, D = 24, 6, 50, 8
    table, idx, w = cpu(V, D).requires_grad_(True), ids(N, V), torch.ones(N)
    (want,) = torch.autograd.grad(ops.embedding_bag(table, idx, w, nb, masked=True).sum(), table)
    mt = meta(V, D).requires_grad_(True)
    tr, (got,) = trace(lambda: torch.autograd.grad(
        ops.embedding_bag(mt, ids(N, V, "meta"), meta(N), nb, masked=True).sum(), mt))
    return tr, got, want, {"embedding_bag": 1, "embedding_bag_masked": 1,
                           "embedding_bag_backward": 1}, {
        "embedding_bag_backward": ((nb * D + V * D) * 4 + N * 8, {"f32": 2 * N * D})}


def _k2(backward):
    B, F, D = 4, 5, 16
    x = cpu(B, F, D).requires_grad_(backward)
    mx = meta(B, F, D).requires_grad_(backward)
    T = F * (F + 1) // 2
    if backward:
        (want,) = torch.autograd.grad(ops.dot_interaction_triu(x).sum(), x)
        tr, (got,) = trace(lambda: torch.autograd.grad(ops.dot_interaction_triu(mx).sum(), mx))
        return tr, got, want, {"dot_interaction": 1, "dot_interaction_backward": 1}, {
            "dot_interaction_backward": ((2 * B * F * D + B * T) * 4, {"f32": 2 * B * F * F * D})}
    want = ops.dot_interaction_triu(x)
    tr, got = trace(lambda: ops.dot_interaction_triu(mx))
    return tr, got, want, {"dot_interaction": 1}, {
        "dot_interaction": (B * F * D * 4 + B * F * F * 4, {"f32": 2 * B * F * F * D})}


def _k3():
    C, D, N, nb = 16, 8, 12, 3
    want = HREF.probe_gather_pool_ref(ids(C, 40), cpu(C, D), ids(N, 40), torch.ones(N), nb, 8)
    tr, got = trace(lambda: HK.probe_gather_pool(ids(C, 40, "meta"), meta(C, D),
                                                 ids(N, 40, "meta"), meta(N), nb))
    return tr, got, want, {"probe_gather_pool": 1}, {
        "probe_gather_pool": (N * (13 + D * 4) + nb * D * 4, {"f32": 2 * N * D})}


def _k4():
    C, D, K = 16, 8, 5
    want = HREF.scatter_update_ref(cpu(C, D), ids(K, C), cpu(K, D, dtype=BF16))
    tr, got = trace(lambda: HK.scatter_update(meta(C, D), ids(K, C, "meta"),
                                              meta(K, D, dtype=BF16)))
    return tr, got, want, {"scatter_update": 1}, {"scatter_update": (K * (4 + D * (2 + 4)), {})}


def _k5():
    M_, L, k = 6, 20, 4
    want = PREF.topk_neighbor_select_ref(cpu(M_, L, dtype=torch.float64), k)
    tr, got = trace(lambda: PK.topk_neighbor_select(meta(M_, L, dtype=torch.float64), k))
    return tr, got, want, {"topk_neighbor_select": 1}, {
        "topk_neighbor_select": (M_ * L * 8 + M_ * k * 12, {})}


def _k6(dtype, backward, causal=True):
    B, S, H, Hkv, dh = 2, 24, 4, 2, 64 if dtype == BF16 else 32
    pairs = S * (S + 1) // 2 if causal else S * S
    item = 2 if dtype == BF16 else 4
    cls, mult = ("bf16", 1) if dtype == BF16 else ("tf32", 3)
    qkv = [cpu(B, S, h, dh, dtype=dtype, seed=i).requires_grad_(backward)
           for i, h in enumerate((H, Hkv, Hkv))]
    mqkv = [meta(B, S, h, dh, dtype=dtype).requires_grad_(backward) for h in (H, Hkv, Hkv)]
    fwd = (2 * B * S * H * dh + 2 * B * S * Hkv * dh) * item
    if not backward:
        want = ops.flash_attention(*qkv, causal)
        tr, got = trace(lambda: ops.flash_attention(*mqkv, causal))
        names = {"flash_attention": 1, **({"flash_attention_f32": 1} if dtype == F32 else {})}
        return tr, got, want, names, {
            "flash_attention": (fwd, {cls: mult * 4 * B * H * pairs * dh})}
    want = torch.autograd.grad(ops.flash_attention(*qkv, causal).sum(), qkv)
    tr, got = trace(lambda: torch.autograd.grad(ops.flash_attention(*mqkv, causal).sum(), mqkv))
    f32 = dtype == F32
    names = {"flash_attention": 1, "flash_attention_backward": 1,
             **({"flash_attention_f32": 1, "flash_attention_backward_f32": 1} if f32 else {})}
    return tr, got, want, names, {
        "flash_attention": (fwd + B * H * S * 4, {cls: mult * 4 * B * H * pairs * dh}),
        "flash_attention_backward": (2 * fwd + B * H * S * 4,
                                     {cls: mult * 10 * B * H * pairs * dh})}


def _k7(partial):
    B, S, H, Hkv, dh = 2, 40, 4, 2, 32
    q, k, v = cpu(B, H, dh), cpu(B, S, Hkv, dh, seed=1), cpu(B, S, Hkv, dh, seed=2)
    n = torch.tensor([17], dtype=torch.int32)
    mq, mk, mv = meta(B, H, dh), meta(B, S, Hkv, dh), meta(B, S, Hkv, dh)
    mn = torch.empty(1, dtype=torch.int32, device="meta")
    flops = {"f32": 4 * B * H * S * dh}
    caches = 2 * B * S * Hkv * dh * 4
    if partial:
        s = torch.tensor([8], dtype=torch.int32)
        want = ops.flash_decode_partial(q, k, v, n, s)
        tr, got = trace(lambda: ops.flash_decode_partial(mq, mk, mv, mn, mn.clone()))
        return tr, got, want, {"flash_decode": 1, "flash_decode_partial": 1}, {
            "flash_decode": (B * H * dh * 4 + B * H * (dh + 2) * 4 + caches, flops)}
    want = ops.flash_decode(q, k, v, n)
    tr, got = trace(lambda: ops.flash_decode(mq, mk, mv, mn))
    return tr, got, want, {"flash_decode": 1}, {"flash_decode": (2 * B * H * dh * 4 + caches,
                                                                 flops)}


KERNEL_CASES = {
    "K1_masked": functools.partial(_k1, True), "K1_weighted": functools.partial(_k1, False),
    "K1_backward": _k1_backward, "K2": functools.partial(_k2, False),
    "K2_backward": functools.partial(_k2, True), "K3": _k3, "K4": _k4, "K5": _k5,
    "K6_bf16": functools.partial(_k6, BF16, False), "K6_f32": functools.partial(_k6, F32, False),
    "K6_f32_full": functools.partial(_k6, F32, False, False),
    "K6_backward_bf16": functools.partial(_k6, BF16, True),
    "K6_backward_f32": functools.partial(_k6, F32, True),
    "K7": functools.partial(_k7, False), "K7_partial": functools.partial(_k7, True),
}


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_entry_points_on_meta(case):
    """On meta each entry point gives its plain version's shapes and dtypes,
    launches nothing, and reports each launch once with the formula's
    work."""
    tr, got, want, launches, works = KERNEL_CASES[case]()
    got, want = _leaves(got), _leaves(want)
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    assert all(g.device.type == "meta" for g in got)
    assert tr.kernel_launches() == launches
    for name, (nbytes, flops) in works.items():
        k = tr.kernels[name]
        assert k["bytes"] == nbytes
        assert {c: k[c] for c in ("bf16", "tf32", "f32")} == {
            c: float(flops.get(c, 0)) for c in ("bf16", "tf32", "f32")}


def test_meta_route_counts_no_launch():
    from repro_torch.kernels import dot_interaction as K2
    from repro_torch.kernels import embedding_bag as K1

    before = (K1.launches, K1.launches_backward, K2.launches, dict(HK.launches), PK.launches)
    for case in KERNEL_CASES.values():
        case()
    assert (K1.launches, K1.launches_backward, K2.launches, dict(HK.launches),
            PK.launches) == before


@pytest.mark.parametrize("entry", ["embedding_bag", "flash_attention", "probe_gather_pool"])
def test_meta_beside_cpu_raises(entry):
    with pytest.raises(ValueError, match="one device type"):
        if entry == "embedding_bag":
            ops.embedding_bag(meta(8, 4), ids(4, 8), torch.ones(4), 2)
        elif entry == "flash_attention":
            ops.flash_attention(meta(1, 4, 2, 32), cpu(1, 4, 2, 32), cpu(1, 4, 2, 32))
        else:
            HK.probe_gather_pool(ids(8, 8), meta(8, 4), ids(4, 8), torch.ones(4), 2)


# ----------------------------------------------------------- DryMesh


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter", "all_reduce_max"])
def test_dry_mesh_collectives_follow_the_ring_model(op):
    mesh = M.DryMesh((2, 4), ("data", "model"), rank=5)
    assert mesh.coords == {"data": 1, "model": 1}
    assert mesh.group_ranks("model") == (4, 5, 6, 7) and mesh.group_ranks("data") == (1, 5)
    x = meta(8, 3).requires_grad_(op != "all_reduce_max")
    before_b, before_c = M.comm_bytes(), M.comm_calls()
    with H.Trace() as tr:
        if op == "all_reduce":
            y = M.all_reduce(x, "model", mesh)
            shape, back = (8, 3), ("all_reduce", 8 * 3 * 4)
        elif op == "all_gather":
            y = M.all_gather(x, "model", mesh)
            shape, back = (32, 3), ("reduce_scatter", 8 * 3 * 4)
        elif op == "reduce_scatter":
            y = M.reduce_scatter(x, "model", mesh)
            shape, back = (2, 3), ("all_gather", 8 * 3 * 4)
        else:
            y = M.all_reduce_max(x, "model", mesh)
            shape, back = (8, 3), None
        if back:
            y.sum().backward()
    assert y.shape == shape and y.device.type == "meta"
    out_bytes = math.prod(shape) * 4
    ring = M.ring_bytes(op, 8 * 3 * 4 if op.startswith("all_reduce") else out_bytes, 4)
    want = {op: ring}
    if back:
        want[back[0]] = want.get(back[0], 0) + M.ring_bytes(back[0], back[1], 4)
    got = {k: v - before_b.get(k, 0) for k, v in M.comm_bytes().items() if v != before_b.get(k, 0)}
    assert got == want
    calls = {k: v - before_c.get(k, 0) for k, v in M.comm_calls().items()
             if v != before_c.get(k, 0)}
    assert calls == {k: (2 if back and back[0] == op else 1) for k in want}
    assert tr.collective_bytes() == want


def test_dry_mesh_refuses_other_tensors_and_a_real_mesh_refuses_meta():
    mesh = M.DryMesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="meta tensors only"):
        M.all_reduce(torch.zeros(4), "model", mesh)
    with pytest.raises(RuntimeError, match="no process groups"):
        mesh.group("model")
    real = M.Mesh.__new__(M.Mesh)  # a rank's view without its groups: refused first
    real.shape, real.axis_names = {"data": 2, "model": 4}, ("data", "model")
    real.coords, real.backend = {"data": 0, "model": 0}, "gloo"
    for fn in (M.all_reduce, M.all_gather, M.reduce_scatter):
        with pytest.raises(ValueError, match="no meta tensor"):
            fn(meta(8, 2), "model", real)
    with pytest.raises(ValueError, match="outside a mesh"):
        M.DryMesh((2, 4), ("data", "model"), rank=8)


def test_production_mesh_still_needs_its_ranks():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        M.make_production_mesh()


def test_recsys_step_takes_its_specs_without_allocating():
    """A recsys step under a mesh takes its gradients' specs from their own
    tree (``param_specs(..., like=)``), the same specs as from
    ``abstract_params``, and allocates nothing for them: the dry run counts
    meta storages, and whole abstract tables would count as the step's."""
    from repro_torch.launch import train as launch_train
    from repro_torch.models import recsys as R

    cfg = launch_train.make_dlrm_100m()
    grads = R.init_params(cfg, 0, 4, device="meta")
    with H.Trace() as tr:
        specs = R.param_specs(cfg, 4, like=grads)
    assert tr.storages == 0 and tr.peak_bytes == 0
    assert specs == R.param_specs(cfg, 4)


# --------------------------------------------------------- run_cell


def _reference_record_keys() -> tuple[list, list]:
    """The keys of the reference's ``run_cell`` record and of its
    memory_analysis dict, read from its source (importing it would force
    512 host devices on this process's JAX)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    record = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "record")
    mem = next(n.iter for n in ast.walk(fn) if isinstance(n, ast.For))
    return ([k.value for k in record.keys],
            [e.value for e in mem.elts] + ["per_device_total"])


@pytest.fixture
def cut_lms(monkeypatch):
    """Every LM arch in the registry with its config cut to LM_CUT_LAYERS
    layers (one remat group each), widths as published."""
    for arch_id, arch in list(configs.REGISTRY.items()):
        if not arch.kind.startswith("lm"):
            continue
        kw = dict(arch.build_cell.keywords)
        base = kw.pop("base_cfg")
        cut = dataclasses.replace(base, n_layers=LM_CUT_LAYERS,
                                  remat_groups=min(base.remat_groups, LM_CUT_LAYERS))
        monkeypatch.setitem(configs.REGISTRY, arch_id, dataclasses.replace(
            arch, build_cell=functools.partial(LC._build, base_cfg=cut, **kw)))


CELLS = [(a, s) for a in sorted(configs.REGISTRY) for s in configs.get(a).shapes]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_run_cell_on_the_production_meshes(cut_lms, tmp_path, capsys, arch_id, shape,
                                           multi_pod):
    rec = D.run_cell(arch_id, shape, multi_pod, tmp_path)
    keys, mem_keys = _reference_record_keys()
    assert list(rec) == keys and list(rec["memory_analysis"]) == mem_keys
    assert list(rec["roofline"]) == list(JH.RooflineTerms(0, 0, 0, 0, 0, 0, {}).as_dict())
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    mem, roof = rec["memory_analysis"], rec["roofline"]
    assert mem["argument_size_in_bytes"] > 0 and mem["per_device_total"] >= (
        mem["argument_size_in_bytes"])
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    on_disk = json.loads((tmp_path / f"{arch_id}__{shape}__{rec['mesh']}.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert f"== {arch_id} x {shape} x {rec['mesh']}" in capsys.readouterr().out


DECODE_CELLS = [(a, s) for a in sorted(configs.REGISTRY) if configs.get(a).kind.startswith("lm")
                for s in configs.get(a).shapes if LC.LM_SHAPES[s]["kind"] == "decode"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id,shape", DECODE_CELLS, ids=[f"{a}-{s}" for a, s in DECODE_CELLS])
def test_decode_cell_arguments_fit_an_h100_at_full_depth(arch_id, shape, multi_pod):
    """Each rank's blocks of an LM decode cell's arguments (its params in
    the cell's ``in_shardings``, which its step takes, and its caches) at
    full depth on both production meshes, cut on meta without tracing: below
    an H100's 80 GB; the query and output projections a tp-th of the whole
    or less."""
    mesh = M.DryMesh(*M.PRODUCTION_SHAPES[multi_pod])
    build = configs.get(arch_id).build_cell(shape, mesh, multi_pod)
    args = D.rank_blocks(build.args, build.in_shardings, mesh)
    per_rank = D._bytes(D._tensors(args))
    assert 0 < per_rank < H.HBM_BYTES
    for name in ("wq", "wo"):
        whole, block = (a[0]["layers"][name].numel() for a in (build.args, args))
        assert block * mesh.shape["model"] <= whole


def test_every_rank_gives_the_same_terms(tmp_path):
    recs = []
    for rank in (0, 37, 255):
        D.main(["--arch", "dlrm-flexemr", "--shape", "train_batch", "--rank", str(rank),
                "--out-dir", str(tmp_path)])
        recs.append(json.loads((tmp_path / "dlrm-flexemr__train_batch__16x16.json").read_text()))
    for r in recs[1:]:
        assert r["roofline"] == recs[0]["roofline"]
        assert r["memory_analysis"] == recs[0]["memory_analysis"]
    assert recs[0]["cost_analysis_raw"]["kernels"]["embedding_bag"]["launches"] >= 1


def test_molecule_traces_on_a_rank_whose_block_is_empty(tmp_path):
    """The molecule cell's 8 graphs a data rank over 16 model ranks: rank 0
    computes one graph, rank 15 none; both send the same collectives."""
    full, empty = (D.run_cell("graphsage-reddit", "molecule", False, tmp_path, rank)
                   for rank in (0, 15))
    assert empty["roofline"]["flops_per_device"] < full["roofline"]["flops_per_device"]
    assert empty["cost_analysis_raw"]["collectives"] == full["cost_analysis_raw"]["collectives"]


def test_a_failing_cell_exits_one(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        D.main(["--arch", "dlrm-flexemr", "--shape", "no_such_shape", "--out-dir",
                str(tmp_path)])
    assert exc.value.code == 1 and "1 FAILURES" in capsys.readouterr().out


def test_dense_lm_train_step_counts_k6_as_the_remat_predicts():
    """A cut stablelm train cell on the pod: K6 3 L - G and K6' L times a
    microbatch (the non-reentrant checkpoints stop a group's recompute
    before its last layer), as on the card."""
    base = configs.get("stablelm-3b").build_cell.keywords["base_cfg"]
    cfg = dataclasses.replace(base, n_layers=4, remat_groups=2)
    mesh = M.DryMesh(*M.PRODUCTION_SHAPES[False])
    build = LC.build_lm_cell(cfg, "adam", "train_4k", mesh, False)
    args = D.rank_blocks(build.args, build.in_shardings, mesh)
    with H.Trace() as tr:
        build.step_fn(*args)
    m, rows = cfg.microbatches, 256 // 16  # train_4k's batch over data 16
    launches = m * (3 * 4 - 2)
    assert tr.kernel_launches()["flash_attention"] == launches
    assert tr.kernel_launches()["flash_attention_backward"] == m * 4
    heads = cfg.n_heads // 16  # over model 16
    per_launch = 4 * (rows // m) * heads * (4096 * 4097 // 2) * cfg.d_head
    assert tr.kernels["flash_attention"]["bf16"] == launches * per_launch
