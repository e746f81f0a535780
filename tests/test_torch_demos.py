"""The port's README demos (examples/torch_*.py) against the JAX package's
demos (examples/*.py), on the CPU.

Each JAX demo runs once in a subprocess (``JAX_PLATFORMS=cpu``; the
quickstart also under 8 forced host devices, its mesh), all of them at the
same time; each port demo runs here with ``device="cpu"``.  Every printed
line whose value does not depend on the random init must match letter for
letter: all lines of the hotcache and prefetch demos, the quickstart's
shapes, routing table, rdma-pool and ``bit_equal`` lines, the elastic
demo's rows line.  Then the reference's params, built in-process as each
JAX demo builds them (``jax.random.key(0)``), cross into the port's
``run(params=...)``, and the value lines are held against the reference's
own values:
  * the quickstart's |x| at rtol 1e-5 (K1's tolerance), its cached-path
    error in both packages at most 1e-5 of the oracle's largest magnitude;
  * the elastic loss after 10 steps at rtol 1e-4 (10 Adam and rowwise
    Adagrad steps, other summation orders), its score drift at most 1e-5 in
    both packages.
The port's serve trace goes through the JAX package's trace tool.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import DisaggEmbedding as JaxEmbedding
from repro.core import TableSpec as JaxTableSpec
from repro.core import make_cache_from_table as jax_make_cache
from repro.data import synthetic as jsyn
from repro.models import recsys as JR
from repro.optim import optimizers as JO
from repro.runtime.elastic import reshard_params as jax_reshard_params

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

import torch_elastic_reshard as elastic  # noqa: E402
import torch_hotcache_demo as hotcache  # noqa: E402
import torch_prefetch_demo as prefetch  # noqa: E402
import torch_quickstart as quickstart  # noqa: E402

RTOL = 1e-5
LOSS_RTOL = 1e-4
MAX_DRIFT = 1e-5
REF_TIMEOUT_S = 240
MESH_DEVICES = 8

# name -> (script, extra environment)
JAX_DEMOS = {
    "quickstart": ("quickstart.py", {}),
    "quickstart_mesh": ("quickstart.py", {
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={MESH_DEVICES}"}),
    "hotcache": ("hotcache_demo.py", {}),
    "prefetch": ("prefetch_demo.py", {}),
    "elastic": ("elastic_reshard.py", {}),
}


@pytest.fixture(scope="module")
def jax_lines():
    """Each JAX demo's printed lines, the five run at once."""
    procs = {}
    for name, (script, extra) in JAX_DEMOS.items():
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"), **extra)
        procs[name] = subprocess.Popen([sys.executable, str(ROOT / "examples" / script)],
                                       env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=REF_TIMEOUT_S)
            assert p.returncode == 0, f"{name}: {stderr[-4000:]}"
            out[name] = stdout.splitlines()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def port_lines(capsys, fn, *args, **kwargs):
    capsys.readouterr()
    res = fn(*args, **kwargs)
    return res, capsys.readouterr().out.splitlines()


def jax_specs(specs) -> tuple:
    return tuple(JaxTableSpec(s.name, s.vocab, nnz=s.nnz, pooling=s.pooling) for s in specs)


def jax_table(specs, shards: int) -> tuple:
    """The reference demo's embedding and params: ``init(jax.random.key(0))``."""
    emb = JaxEmbedding(specs=jax_specs(specs), dim=32, num_shards=shards)
    return emb, emb.init(jax.random.key(0))


QUICKSTART_KEEP = ("baseline", "hierarchical", "routing table", "  (", "rdma pool",
                   "engine-pool", "pipelined")


def quickstart_kept(lines) -> list[str]:
    """The quickstart's lines that the random init does not decide: the
    shapes (|x| cut off), the routing table, the pool and bit_equal lines."""
    return [ln.split("|x|=")[0] for ln in lines if ln.startswith(QUICKSTART_KEEP)]


# ------------------------------------------------------------ printed lines


def test_hotcache_demo_prints_the_reference_lines(jax_lines, capsys):
    res, lines = port_lines(capsys, hotcache.run, "cpu")
    assert lines == jax_lines["hotcache"]
    assert res["oracle_max_err"] <= 1e-4


def test_prefetch_demo_prints_the_reference_lines(jax_lines, capsys):
    res, lines = port_lines(capsys, prefetch.run, "cpu")
    assert lines == jax_lines["prefetch"]
    assert res["with_prefetch"]["prefetch_issued"] > 0


def test_quickstart_prints_the_reference_lines(jax_lines, capsys):
    res, lines = port_lines(capsys, quickstart.run, "cpu")
    kept = quickstart_kept(lines)
    assert kept == quickstart_kept(jax_lines["quickstart"])
    assert len(kept) == 11
    assert res["pool_bit_equal"] and res["pipelined_bit_equal"]
    assert "pipelined lookup_async (2 in flight): bit_equal = True" in lines


def test_quickstart_ranks_prints_the_reference_mesh_lines(jax_lines, capsys):
    """``--ranks 8`` (8 gloo ranks, mesh (data 2, model 4)) on the
    reference's params (laid out for 4 servers) against the JAX quickstart
    under 8 forced host devices: the mesh line and the kept lines; |x| and
    the cached error against the reference's one-device lookup of the same
    params.  No rank launches a kernel on the CPU."""
    jemb, jparams = jax_table(quickstart.SPECS, MESH_DEVICES // 2)
    res, lines = port_lines(capsys, quickstart.run, "cpu", ranks=MESH_DEVICES,
                            params={"table": np.asarray(jparams["table"])})
    assert lines[0] == jax_lines["quickstart_mesh"][0] == "mesh: {'data': 2, 'model': 4}"
    assert quickstart_kept(lines) == quickstart_kept(jax_lines["quickstart_mesh"])
    want = quickstart_reference(jemb, jparams)
    for mode in quickstart.MODES:
        np.testing.assert_allclose(res[mode]["abs_mean"], want[mode], rtol=RTOL)
    assert res["cached_max_err"] <= RTOL * want["oracle_max"]
    assert len(res["rank_launches"]) == MESH_DEVICES
    assert not any(any(r.values()) for r in res["rank_launches"])


def test_elastic_demo_prints_the_reference_rows(jax_lines, capsys):
    res, lines = port_lines(capsys, elastic.run, "cpu")
    want = "resharded 4 -> 8 servers; rows 58528 -> 58560"
    assert want in lines and want in jax_lines["elastic"]
    assert lines[-1] == jax_lines["elastic"][-1] == "elastic reshard is lossless"
    assert res["rows"] == [58528, 58560] and res["max_score_drift"] < MAX_DRIFT


# ---------------------------------------------------- the reference's params


def quickstart_reference(jemb, jparams) -> dict:
    """The JAX quickstart's values on its params, one device: each mode's
    |x| (the same embedding, as the demo's), the cached error and the
    oracle's largest magnitude."""
    batch = jsyn.recsys_batch(np.random.default_rng(0), jemb.specs, quickstart.BATCH)
    idx, msk = jnp.asarray(batch["indices"]), jnp.asarray(batch["mask"])
    out = {}
    for mode in quickstart.MODES:
        emb = JaxEmbedding(specs=jemb.specs, dim=32, num_shards=jemb.num_shards, mode=mode)
        out[mode] = float(jnp.abs(emb.lookup(jparams, idx, msk)).mean())
    cache = jax_make_cache(jemb, jparams, np.arange(quickstart.HOT), quickstart.HOT)
    plain = jemb.lookup_reference(jparams, idx, msk)
    out["cached_max_err"] = float(jnp.abs(jemb.lookup(jparams, idx, msk, cache=cache)
                                          - plain).max())
    out["oracle_max"] = float(jnp.abs(plain).max())
    return out


def test_quickstart_on_the_reference_params():
    jemb, jparams = jax_table(quickstart.SPECS, 1)
    res = quickstart.run("cpu", params={"table": np.asarray(jparams["table"])})
    want = quickstart_reference(jemb, jparams)
    for mode in quickstart.MODES:
        np.testing.assert_allclose(res[mode]["abs_mean"], want[mode], rtol=RTOL)
    assert want["cached_max_err"] <= RTOL * want["oracle_max"]
    assert res["cached_max_err"] <= RTOL * want["oracle_max"]


@pytest.mark.parametrize("demo", [hotcache, prefetch], ids=["hotcache", "prefetch"])
def test_tier_demo_on_the_reference_params(demo):
    """The tier's outputs on the reference's table equal the port's oracle
    on it (the demo's own allclose, rtol 1e-4, atol 1e-5, raises otherwise)."""
    _, jparams = jax_table(demo.SPECS, demo.SHARDS)
    res = demo.run("cpu", params={"table": np.asarray(jparams["table"])})
    assert res["oracle_max_err"] <= 1e-4


def jax_elastic() -> tuple[dict, float, float]:
    """The JAX elastic demo's initial params, its loss after 10 steps and
    its score drift across the reshard (the demo's steps, without the
    checkpoint's round trip, which restores the same bits)."""
    tables = jax_specs(elastic.TABLES)
    cfg = JR.RecsysConfig(name="elastic-demo", arch="dlrm", tables=tables, embed_dim=32,
                          n_dense=13, bottom_mlp=(128, 32), mlp=(128, 64))
    opt = JO.make_composite([("emb", JO.make_rowwise_adagrad(0.05)),
                             (".*", JO.make_adam(1e-3))])
    params = JR.init_params(cfg, jax.random.key(0), num_shards=elastic.SHARDS)
    init = jax.tree_util.tree_map(np.asarray, params)
    state = opt.init(params)
    step = jax.jit(JR.make_train_step(cfg, opt, None))
    batch = {k: jnp.asarray(v) for k, v in jsyn.recsys_batch(
        np.random.default_rng(0), tables, 128, n_dense=13).items()}
    for _ in range(elastic.STEPS):
        params, state, m = step(params, state, batch)
    before = JR.forward(cfg, params, batch, None)
    _, new_emb = jax_reshard_params(cfg.embedding(elastic.SHARDS).sharded, params["emb"],
                                    elastic.RESHARD_TO)
    after = JR.forward(cfg, dict(params, emb={"table": jnp.asarray(new_emb["table"])}),
                       batch, None)
    return init, float(m["loss"]), float(jnp.abs(before - after).max())


def test_elastic_on_the_reference_params():
    init, loss, drift = jax_elastic()
    res = elastic.run("cpu", params=init)
    np.testing.assert_allclose(res["loss"], loss, rtol=LOSS_RTOL)
    assert drift <= MAX_DRIFT and res["max_score_drift"] <= MAX_DRIFT
    assert res["rows"] == [58528, 58560]


# ------------------------------------------------------- the reference's tool


def test_port_trace_reads_with_the_reference_trace_tool():
    """``repro_torch.launch.serve``'s trace through ``tools/trace_export.py``
    (plain, ``--summarize``, ``--attribution``): each exits 0 and the
    attribution covers the whole end-to-end time."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "t.json")
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device",
                              "cpu", "--requests", "64", "--scale", "0.05", "--trace", trace],
                             env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-4000:]
        for flags in ([], ["--summarize"], ["--attribution"]):
            tool = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_export.py"),
                                   trace, *flags], cwd=ROOT, capture_output=True, text=True,
                                  timeout=60)
            assert tool.returncode == 0, (flags, tool.stderr[-4000:])
        assert "(coverage 100.00%)" in tool.stdout
