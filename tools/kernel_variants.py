#!/usr/bin/env python3
"""Time text variants of a CUDA kernel of the port against its committed source.

    python3 tools/kernel_variants.py [--against DIR] tools/kernel_variants/k6_stages.json [...]

on a machine with one NVIDIA GPU, from the repo root.  A spec file holds

    {"kernel": "flash_attention" | "flash_attention_backward" | "dot_interaction"
               | "flash_decode" | "scatter_update" | "embedding_bag" | "probe_gather_pool"
               | "topk_neighbor_select",
     "cases": [...],
     "variants": [{"name": ..., "subs": [[old, new], ...], "check": true}, ...]}

with cases [B, S, H, Hkv, dh] (flash_attention, bf16 causal; entries after
the fifth: "f32" runs it in f32, "lse" writes the row logsumexp too (held
at 2e-5), "full" drops the causal mask; checked twice bit-equal;
flash_attention_backward's K6', bf16 causal, from
the plain version's output and logsumexp, a random dO; "full" after the
fifth entry drops the causal mask, "f32" runs it in f32, "device" times it
by ``chip_smoke.device_ms``, the device's time alone with the host's
enqueue hidden, as phase 9g times the launch-sized cases), [M, L, k, "f32" | "f64"] (topk_neighbor_select on
scores on a grid of 1/4 with -inf, NaN and -0.0 scattered in), [B, F, D]
(dot_interaction, f32), [B, S, H, Hkv, dh, cache_len] (flash_decode, bf16,
NaN past cache_len; a seventh entry "f32" runs it in f32), [C, D, K]
(scatter_update: K f32 rows of D into distinct random slots of a [C, D] f32
table, as a hot-cache build writes them), [bags, nnz, D, live_frac]
(embedding_bag on dlrm-flexemr's 150,080,000-row f32 table: uniform random
ids, a slot live with probability live_frac, masked mode; "weighted" as a
last entry runs the weighted mode), ["forward", B] (embedding_bag on the
forward's own fused ids and mask at batch B, as chip_smoke.py makes them;
"weighted" as a third entry), [C, bags, nnz, D, hit_frac]
(probe_gather_pool over a cache of C f32 slots 40% full: a slot holds a
resident id with probability hit_frac, a cold id with probability
hit_frac, else EMPTY_KEY at weight 0, as a masked slot reaches it) or
["forward", B, C] (probe_gather_pool on the cached forward's query at
batch B over a cache of C slots holding the hot ids of 4 warm-up batches,
as chip_smoke.py builds it).  The backward kernels: ["backward", B]
(embedding_bag's K1' on dlrm-100m's lookup of the trainer's batch of B, as
chip_smoke.py's train phase builds it: masked, a random gradient),
["backward", arch] (K1' on an arch's train step, as phase 5g builds it:
``chip_smoke.recsys_train_batch`` and ``k1b_step_inputs``, Zipf ids whose
hot rows' runs span the batch; "wide" as a third entry takes the separate
wide table's D; checked by ``chip_smoke.k1b_hold_slot_order``: the
touched rows bit-equal to host sums in slot order, the rest 0.0, two
launches bit-equal),
["backward", bags, nnz, D, V, live_frac] (K1', masked, uniform ids in
[0, V), a slot live with probability live_frac) and ["backward", B, F, D]
(dot_interaction's K2' on random x and triangle gradients, f32).
Each variant is ``src/repro_torch/csrc/<kernel>.cu`` with every ``old``
replaced by ``new`` (each must occur); the committed source runs as the
variant ``base``.  ``--against DIR`` adds to every spec the variant
``against``: the kernel's source in another checkout unpacked at ``DIR``
(its ``src/repro_torch/csrc/``, headers included), built alike and run
through this checkout's wrapper, so two designs with one C interface are
timed in turns in one process; where that checkout's wrapper of a
backward kernel has another C interface (K1' and K2' before their
redesign, and K6' whose designs size their scratch apart), the variant
runs through that checkout's own wrapper function (``PARENT_WRAPPED``),
loaded from its file.  A variant may also set ``"attrs"``:
attributes of the kernel's wrapper module (such as K7's ``MAX_CHUNK``) that
hold while it is checked and timed, and ``"flush": "read"``: the L2 is
flushed before each of its timings by reading a 256 MB buffer instead of
writing it, so no dirty lines are left for the kernel to write back.  Every
variant of every spec is built at once, one nvcc each, with the flags of
``kernels/build.py``, into ``build/kernel_variants/`` (printing the
registers each kernel's SASS names, where ``cuobjdump`` is there: past the
launch bound's count where setmaxnreg gave a warpgroup more), and runs through the
kernel's own wrapper (``build.use_library``).  At each case a variant with
``check`` (the default) is first held against the plain version as
``chip_smoke.py`` holds the kernel (K6 and K7 in bf16 by
``assert_close_rows`` and at 2e-5 in f32, K6' as phase 9g holds it: dq, dk
and dv by ``assert_close_rows`` with the head floor ``K6B_FLOOR`` in bf16,
at 2e-5 in f32, and two launches bit-equal, K2 f32 at 1e-4, K4 bit-equal, K1
at 1e-5, K3's miss mask bit-equal and its sums at 1e-5, K5 bit-equal, K1'
twice bit-equal, bit-equal to its plain version on the CPU and within
``K1B_TOL`` of it on the card, K2' at 1e-5); a
variant that cuts work out sets ``"check": false``.  Then every variant and
the library call (``F.scaled_dot_product_attention``, its backward alone
for K6' (``chip_smoke.sdpa_backward``), ``torch.bmm``,
``index_copy_``, ``F.embedding_bag`` or ``torch.topk``; for K1'
``index_add_`` of the live slots' weighted rows into a zeroed table, for
K2' ``torch.bmm`` of G + G^T and x; none for probe_gather_pool) are timed
by CUDA events, L2 flushed, in turns:
``ROUNDS`` rounds, the order reversed every round, the card idle for
``PAUSE_S`` before each timing so that every one starts from the same clocks
rather than from the heat of the last (without it, one build read slower
round after round of one call).  One JSON line per case gives each one's
median in ms over the rounds and its time in every round, so that pairs of
rounds can be counted, with the card's name and power limit.  A spec's
``"launches"``, a list of kernel names, adds a line a case with each
variant's device time a launch of each (``chip_smoke.device_busy``, a
profiler window of 10 calls, L2 not flushed), which splits a call that
launches several kernels.
"""
from __future__ import annotations

import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.configs.dlrm_flexemr import make_config  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.hotcache import kernels as HK  # noqa: E402
from repro_torch.hotcache import ref as HREF  # noqa: E402
from repro_torch.hotcache import table as T  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import dot_interaction as K2  # noqa: E402
from repro_torch.kernels import embedding_bag as K1  # noqa: E402
from repro_torch.kernels import flash_attention as K6  # noqa: E402
from repro_torch.kernels import flash_decode as K7  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.prefetch import kernels as PK  # noqa: E402
from repro_torch.prefetch import ref as PREF  # noqa: E402

OUT = ROOT / "build" / "kernel_variants"
CSRC_REL = Path("src/repro_torch/csrc")
WRAPPERS = {"flash_attention": K6, "flash_attention_backward": K6, "dot_interaction": K2,
            "flash_decode": K7,
            "scatter_update": HK, "embedding_bag": K1, "probe_gather_pool": HK,
            "topk_neighbor_select": PK}
MAX_PROBES = 8  # the hot cache's window (hotcache.table.DEFAULT_MAX_PROBES)
ROUNDS = 10  # pairs of rounds for each two variants
PAUSE_S = 1.0
CACHE_FILL = 0.4  # K3 cases: resident ids per slot
_tables: dict[int, torch.Tensor] = {}  # K1 cases: dlrm-flexemr's table by D
# wrapper functions whose C interface changed with the backward kernels'
# redesign: an ``--against`` checkout's own function runs its library
PARENT_WRAPPED = {"embedding_bag": ("embedding_bag_backward",),
                  "dot_interaction": ("dot_interaction_backward",),
                  "flash_attention_backward": ("flash_attention_backward",)}


def build_variants(specs: dict[str, dict],
                   against: Path | None = None) -> dict[str, dict[str, tuple[dict, Path]]]:
    """{spec: {variant: (variant, library path)}}, the committed source as
    ``base``, the source of the checkout at ``against`` as ``against``."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for tag, spec in specs.items():
        libs[tag] = {}
        extra = [] if against is None else [{
            "name": "against", "csrc": against / CSRC_REL,
            "attrs": parent_functions(against, spec["kernel"])}]
        for v in [{"name": "base", "subs": []}, *spec["variants"], *extra]:
            csrc = v.get("csrc", build.CSRC)
            src = (csrc / f"{spec['kernel']}.cu").read_text()
            for old, new in v.get("subs", []):
                if old not in src:
                    raise ValueError(f"{tag} {v['name']}: {old!r} not in {spec['kernel']}.cu")
                src = src.replace(old, new)
            cu = OUT / f"{tag}_{v['name']}.cu"
            cu.write_text(src)
            so = cu.with_suffix(".so")
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc),
                   "-o", str(so), str(cu)]
            procs.append((f"{tag} {v['name']}", subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            libs[tag][v["name"]] = (v, so)
    for label, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for line in log.splitlines():
            if "C75" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print(f"  {label}: {line.strip()}", flush=True)
        so = libs[label.split()[0]][label.split()[1]][1]
        regs = sass_registers(so)
        if regs:
            print(json.dumps({"variant": label, "sass_registers": regs}), flush=True)
    return libs


def sass_registers(so: Path) -> dict:
    """{kernel: registers its SASS names (the highest R index + 1)} of a
    built library, by ``cuobjdump -sass``: above the launch bound's count
    where setmaxnreg gave a warpgroup more.  Empty without cuobjdump."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True).stdout
    regs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            regs[name] = 0
        elif name is not None:
            for r in re.findall(r"\bR(\d+)\b", line):
                regs[name] = max(regs[name], int(r) + 1)
    return {CS.kernel_name(n): r for n, r in regs.items()}


def parent_functions(root: Path, kernel: str) -> dict:
    """The functions of ``PARENT_WRAPPED[kernel]`` from the wrapper module of
    the checkout at ``root`` (its ``kernels/<kernel>.py``, loaded under
    another name; it binds the library ``build.use_library`` names)."""
    names = PARENT_WRAPPED.get(kernel, ())
    if not names:
        return {}
    module = WRAPPERS[kernel].__name__.rsplit(".", 1)[1]  # K6' lives in flash_attention.py
    path = root / "src/repro_torch/kernels" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(f"against_{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return {n: getattr(mod, n) for n in names}


def train_inputs(batch: int) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """dlrm-100m's fused ids and 0/1 weights of the trainer's batch of step 0
    (seed 0), flat, its rows and its slots a bag, as ``chip_smoke.py``'s
    train phase makes them."""
    cfg = launch_train.make_dlrm_100m()
    emb = cfg.embedding()
    host = syn.recsys_batch(np.random.default_rng(0), cfg.tables, batch, n_dense=cfg.n_dense)
    ids = emb._fused_rows(emb.sharded, torch.from_numpy(host["indices"])).reshape(-1)
    w = torch.from_numpy(host["mask"]).reshape(-1).to(torch.float32)
    return (ids.contiguous().cuda(), w.contiguous().cuda(), cfg.num_embedding_rows(),
            host["indices"].shape[2])


def backward_setup(tag: str, kernel: str, case: list, gen: torch.Generator):
    """(call, check, library) of a K1' or K2' case (see ``setup``)."""
    if kernel == "dot_interaction":
        _, B, F, D = case
        x = torch.randn((B, F, D), device="cuda", generator=gen)
        tri = torch.randn((B, F * (F + 1) // 2), device="cuda", generator=gen)
        want = ref.dot_interaction_backward_ref(x, tri)
        iu, ju = torch.triu_indices(F, F, device="cuda")
        g_full = torch.zeros((B, F, F), device="cuda")
        g_full[:, iu, ju] = tri
        s_full = g_full + g_full.transpose(1, 2)
        call = lambda: K2.dot_interaction_backward(x, tri)  # noqa: E731
        return (call,
                lambda n: CS.assert_close(f"{tag} {n} {case}", call(), want, 1e-5, 1e-5),
                lambda: torch.bmm(s_full, x))
    if isinstance(case[1], str):  # an arch's train step: Zipf ids, hot rows
        cfg, batch = CS.recsys_train_batch(case[1], torch.device("cuda"))
        g, ids, w, V = CS.k1b_step_inputs(cfg, batch, gen, wide="wide" in case[2:])
        del batch
        nnz = ids.numel() // g.shape[0]
        live_idx = ids[w != 0].long()
        contrib = (g.repeat_interleave(nnz, dim=0) * w[:, None])[w != 0]
        call = lambda: K1.embedding_bag_backward(g, ids, w, V, masked=True)  # noqa: E731

        def check_hot(n):
            got = call()
            print(json.dumps({"spec": tag, "variant": n, "case": case, **CS.k1b_hold_slot_order(
                f"{tag} {n} {case}", got, call(), g, ids, w, V)}), flush=True)

        return (call, check_hot,
                lambda: torch.zeros((V, g.shape[1]), device="cuda").index_add_(0, live_idx,
                                                                               contrib))
    if len(case) == 2:
        ids, w, V, nnz = train_inputs(case[1])
    else:
        _, bags, nnz, _, V, live = case
        ids = torch.randint(0, V, (bags * nnz,), device="cuda", generator=gen,
                            dtype=torch.int32)
        w = (torch.rand(bags * nnz, device="cuda", generator=gen) < live).float()
    D = 64 if len(case) == 2 else case[3]
    bags = ids.numel() // nnz
    g = torch.randn((bags, D), device="cuda", generator=gen)
    want = ref.embedding_bag_backward_ref(g, ids, w, V, masked=True)
    want_cpu = ref.embedding_bag_backward_ref(g.cpu(), ids.cpu(), w.cpu(), V, masked=True)
    live_idx = ids[w != 0].long()
    contrib = (g.repeat_interleave(nnz, dim=0) * w[:, None])[w != 0]
    call = lambda: K1.embedding_bag_backward(g, ids, w, V, masked=True)  # noqa: E731

    def check(n):
        got = call()
        CS.assert_equal(f"{tag} {n} {case} twice", call(), got)
        CS.assert_bits(f"{tag} {n} {case} vs the CPU", got.cpu(), want_cpu)
        CS.assert_close(f"{tag} {n} {case}", got, want, *CS.K1B_TOL)

    return (call, check,
            lambda: torch.zeros((V, D), device="cuda").index_add_(0, live_idx, contrib))


def forward_inputs(batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """dlrm-flexemr's fused ids [B, 26, 4] int32 and mask of one batch, as
    ``chip_smoke.py``'s forward makes them (seed 0)."""
    cfg = make_config()
    host = syn.recsys_batch(np.random.default_rng(0), cfg.tables, batch, n_dense=cfg.n_dense)
    fused = cfg.embedding()._fused_rows(cfg.embedding().sharded,
                                        torch.from_numpy(host["indices"]))
    return fused.cuda(), torch.from_numpy(host["mask"]).cuda()


def hot_ids(batch: int) -> np.ndarray:
    """Fused ids of 4 warm-up batches (seed 1), hottest first: the cached
    forward's hot set in ``chip_smoke.py``."""
    cfg = make_config()
    emb, warm, ids = cfg.embedding(), np.random.default_rng(1), []
    for _ in range(4):
        wb = syn.recsys_batch(warm, cfg.tables, batch, n_dense=cfg.n_dense)
        fused = emb._fused_rows(emb.sharded, torch.from_numpy(wb["indices"])).numpy()
        ids.append(fused[wb["mask"]])
    uniq, counts = np.unique(np.concatenate(ids), return_counts=True)
    return uniq[np.argsort(-counts, kind="stable")]


def _insert(C: int, ids: np.ndarray) -> np.ndarray:
    """The keys [C] of an empty cache after inserting ``ids`` (first ones
    hottest), as ``cache_insert`` places them."""
    ids = np.asarray(ids[:C], np.int32)
    return T.insert_plan(np.full((C,), T.EMPTY_KEY, np.int32), np.zeros((C,), np.int32), ids,
                         np.arange(len(ids), 0, -1, dtype=np.int32), 1, MAX_PROBES)[0]


def setup(tag: str, kernel: str, case: list, gen: torch.Generator):
    """(call, check, library) of one case: the kernel through its wrapper,
    ``check(name)``, which calls it on fresh inputs where it writes in place
    and holds the output against the plain version, and the library call."""
    if case[0] == "backward":
        return backward_setup(tag, kernel, case, gen)
    if kernel == "flash_attention_backward":
        B, S, H, Hkv, dh = case[:5]
        causal = "full" not in case[5:]
        dt = torch.float32 if "f32" in case[5:] else torch.bfloat16
        q, do = (torch.randn((B, S, H, dh), device="cuda", generator=gen).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((B, S, Hkv, dh), device="cuda", generator=gen).to(dt)
                for _ in range(2))
        o, lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
        want = ref.flash_attention_backward_ref(q, k, v, o, lse, do, causal)
        call = lambda: K6.flash_attention_backward(q, k, v, o, lse, do, causal)  # noqa: E731

        def check(n):
            got = call()
            for part, g, w in zip(("dq", "dk", "dv"), got, want):
                if dt == torch.float32:
                    CS.assert_close(f"{tag} {n} {case} {part}", g, w, *CS.LM_F32_TOL)
                else:
                    CS.assert_close_rows(f"{tag} {n} {case} {part}", g, w, *CS.LM_BF16_TOL,
                                         CS.K6B_FLOOR)
            if not all(torch.equal(a, b) for a, b in zip(got, call())):
                raise AssertionError(f"{tag} {n} {case}: two launches differ")

        return call, check, CS.sdpa_backward(q, k, v, do, causal)
    if kernel == "flash_attention":
        B, S, H, Hkv, dh = case[:5]
        dt = torch.float32 if "f32" in case[5:] else torch.bfloat16
        causal = "full" not in case[5:]
        q = torch.randn((B, S, H, dh), device="cuda", generator=gen).to(dt)
        k, v = (torch.randn((B, S, Hkv, dh), device="cuda", generator=gen)
                .to(dt) for _ in range(2))
        want, want_lse = ref.flash_attention_ref(q, k, v, causal, return_lse=True)
        lse = torch.empty((B, H, S), device="cuda") if "lse" in case[5:] else None
        close, tol = ((CS.assert_close_rows, CS.LM_BF16_TOL) if dt == torch.bfloat16
                      else (CS.assert_close, CS.LM_F32_TOL))
        call = lambda: K6.flash_attention(q, k, v, causal, lse=lse)  # noqa: E731

        def check_k6(n):
            got = call()
            close(f"{tag} {n} {case}", got, want, *tol)
            if lse is not None:
                CS.assert_close(f"{tag} {n} {case} logsumexp", lse, want_lse, *CS.LM_F32_TOL)
            if not torch.equal(call(), got):
                raise AssertionError(f"{tag} {n} {case}: two launches differ")

        return (call, check_k6,
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=True))
    if kernel == "dot_interaction":
        x = torch.randn(tuple(case), device="cuda", generator=gen)
        want = ref.dot_interaction_ref(x)
        call = lambda: K2.dot_interaction(x)  # noqa: E731
        return (call,
                lambda n: CS.assert_close(f"{tag} {n} {case}", call(), want, 1e-4, 1e-4),
                lambda: torch.bmm(x, x.transpose(1, 2)))
    if kernel == "flash_decode":
        B, S, H, Hkv, dh, n = case[:6]
        dt = torch.float32 if case[6:] == ["f32"] else torch.bfloat16
        q = torch.randn((B, H, dh), device="cuda", generator=gen).to(dt)
        kc, vc = (torch.randn((B, S, Hkv, dh), device="cuda", generator=gen).to(dt)
                  for _ in range(2))
        kc[:, n:] = float("nan")  # never read
        vc[:, n:] = float("nan")
        n_t = torch.tensor(n, dtype=torch.int32, device="cuda")
        want = ref.flash_decode_ref(q, kc, vc, n_t)
        close, tol = ((CS.assert_close_rows, CS.LM_BF16_TOL) if dt == torch.bfloat16
                      else (CS.assert_close, CS.LM_F32_TOL))
        call = lambda: K7.flash_decode(q, kc, vc, n_t)  # noqa: E731
        return (call,
                lambda name: close(f"{tag} {name} {case}", call(), want, *tol),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2),
                    enable_gqa=True))
    if kernel == "scatter_update":
        C, D, K = case
        slots = torch.randperm(C, device="cuda", generator=gen)[:K].to(torch.int32)
        rows = torch.randn((K, D), device="cuda", generator=gen)
        values = torch.zeros((C, D), device="cuda")
        want = HREF.scatter_update_ref(torch.zeros_like(values), slots, rows)
        slots_l = slots.long()
        return (lambda: HK.scatter_update(values, slots, rows),
                lambda n: CS.assert_equal(f"{tag} {n} {case}", HK.scatter_update(
                    torch.zeros_like(values), slots, rows), want),
                lambda: values.index_copy_(0, slots_l, rows))
    if kernel == "embedding_bag":
        forward = case[0] == "forward"
        D = 64 if forward else case[2]
        kw = {} if case[-1] == "weighted" else {"masked": True}
        if D not in _tables:
            _tables.clear()
            rows = make_config().num_embedding_rows()
            _tables[D] = torch.empty((rows, D), device="cuda").normal_(0, 0.01, generator=gen)
        table = _tables[D]
        if forward:
            ids, mask = forward_inputs(case[1])
            bags, nnz = mask.shape[0] * mask.shape[1], mask.shape[2]
            ids, w = ids.reshape(-1), mask.reshape(-1).float()
        else:
            bags, nnz, D, live = case[:4]
            ids = torch.randint(0, table.shape[0], (bags * nnz,), device="cuda",
                                generator=gen, dtype=torch.int32)
            w = (torch.rand(bags * nnz, device="cuda", generator=gen) < live).float()
        want = ref.embedding_bag_ref(table, ids, w, bags, **kw)
        call = lambda: K1.embedding_bag(table, ids, w, bags, **kw)  # noqa: E731
        return (call,
                lambda n: CS.assert_close(f"{tag} {n} {case}", call(), want, 1e-5, 1e-5),
                lambda: F.embedding_bag(ids.view(bags, nnz), table, mode="sum",
                                        per_sample_weights=w.view(bags, nnz)))
    if kernel == "probe_gather_pool":
        if case[0] == "forward":
            _, B, C = case
            fused, mask = forward_inputs(B)
            keys_np = _insert(C, hot_ids(B))
            bags, D = mask.shape[0] * mask.shape[1], 64
            ids = torch.where(mask, fused, T.EMPTY_KEY).reshape(-1).contiguous()
        else:
            C, bags, nnz, D, hit = case
            rng = np.random.default_rng(0)
            keys_np = _insert(C, rng.choice(1 << 30, int(C * CACHE_FILL), replace=False))
            held = keys_np[keys_np != T.EMPTY_KEY]
            u = rng.random(bags * nnz)
            q = np.where(u < hit, rng.choice(held, bags * nnz),
                         np.where(u < 2 * hit, rng.integers(1 << 30, 1 << 31, bags * nnz),
                                  T.EMPTY_KEY)).astype(np.int32)
            ids = torch.from_numpy(q).cuda()
        keys = torch.from_numpy(keys_np).cuda()
        values = torch.randn((C, D), device="cuda", generator=gen)
        w = (ids != T.EMPTY_KEY).float()
        want = HREF.probe_gather_pool_ref(keys, values, ids, w, bags, MAX_PROBES)
        call = lambda: HK.probe_gather_pool(keys, values, ids, w, bags, MAX_PROBES)  # noqa: E731

        def check(n):
            got = call()
            CS.assert_equal(f"{tag} {n} {case} miss", got[1], want[1])
            CS.assert_close(f"{tag} {n} {case} pooled", got[0], want[0], 1e-5, 1e-5)

        return call, check, None
    if kernel == "topk_neighbor_select":
        M, L, k, dt = case
        s = torch.round(torch.randn((M, L), device="cuda", generator=gen) * 4) / 4
        u = torch.rand((M, L), device="cuda", generator=gen)
        s[u < 0.2] = float("-inf")
        s[(u >= 0.2) & (u < 0.3)] = float("nan")
        s[(u >= 0.3) & (u < 0.4)] = -0.0
        s = s.to({"f32": torch.float32, "f64": torch.float64}[dt]).contiguous()
        want = PREF.topk_neighbor_select_ref(s, k)
        call = lambda: PK.topk_neighbor_select(s, k)  # noqa: E731

        def check(n):
            got = call()
            CS.assert_bits(f"{tag} {n} {case} values", got[0], want[0])
            CS.assert_equal(f"{tag} {n} {case} indices", got[1], want[1])

        return call, check, lambda: torch.topk(s, k, dim=1)
    raise ValueError(f"{tag}: no cases for kernel {kernel!r}")


def run(tag: str, spec: dict, libs: dict, card: str, flush: torch.Tensor,
        gen: torch.Generator) -> None:
    kernel = spec["kernel"]
    for case in spec["cases"]:
        call, check, library = setup(tag, kernel, case, gen)

        def as_variant(variant, so, fn):
            """fn() with the variant's library and wrapper attributes."""
            build.use_library(kernel, so)
            mod = WRAPPERS[kernel]
            attrs = variant.get("attrs", {})
            saved = {a: getattr(mod, a) for a in attrs}
            plan = getattr(mod, "plan_split", None)
            try:
                for a, val in attrs.items():
                    setattr(mod, a, val)
                if plan is not None:
                    plan.cache_clear()
                return fn()
            finally:
                for a, val in saved.items():
                    setattr(mod, a, val)
                if plan is not None:
                    plan.cache_clear()

        for n, (variant, so) in libs.items():
            if variant.get("check", True):
                as_variant(variant, so, lambda: check(n))
        device = "device" in case[5:]

        def timed(fn, v=None):
            if device:
                return CS.device_ms(fn)
            return CS.cuda_ms(fn, flush, read_flush=(v or {}).get("flush") == "read")

        fns = {n: (lambda v=v, so=so: as_variant(v, so, lambda: timed(call, v)))
               for n, (v, so) in libs.items()}
        if library is not None:
            fns["library"] = lambda: timed(library)
        times = {n: [] for n in fns}
        order = list(fns)
        for r in range(ROUNDS):
            for n in (order if r % 2 == 0 else order[::-1]):
                time.sleep(PAUSE_S)
                times[n].append(fns[n]())
        print(json.dumps({"spec": tag, "case": case, "card": card,
                          "median_ms": {n: statistics.median(t) for n, t in times.items()},
                          "round_ms": times}), flush=True)
        if spec.get("launches"):
            names = tuple(spec["launches"])
            split = {n: as_variant(v, so, lambda: CS.device_busy(call, 10, names))
                     for n, (v, so) in libs.items()}
            print(json.dumps({"spec": tag, "case": case, "card": card, "launch_ms": {
                n: b.get("kernels_ms_each") for n, b in split.items()},
                "busy_ms": {n: b["device_busy_ms"] for n, b in split.items()}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA GPU present", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    args = sys.argv[1:]
    against = None
    if args[:1] == ["--against"]:
        against, args = Path(args[1]).resolve(), args[2:]
    specs = {Path(p).stem: json.loads(Path(p).read_text()) for p in args}
    libs = build_variants(specs, against)
    flush = torch.empty(CS.L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, spec in specs.items():
        run(tag, spec, libs[tag], card, flush, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
