"""repro_torch stands alone: it imports neither jax nor the JAX package, and
its entry points refuse to fall back to the CPU when a GPU was asked for."""
import ast
import json
import os
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.sharding import TableSpec, make_fused_tables
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.runtime.serving import FlexEMRServer

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py"))
# the port's demos and examples: scripts beside the JAX package's
PORT_EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
DEMOS = ["torch_quickstart", "torch_hotcache_demo", "torch_prefetch_demo",
         "torch_elastic_reshard", "torch_serve_dlrm"]
REF_INITS = sorted((ROOT / "src" / "repro").rglob("__init__.py"))


def _module_name(path: Path) -> str:
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_every_module_imports_without_jax():
    """Each module, and each of the port's examples, imports with
    ``sys.modules["jax"] = None`` (any jax import then raises), and
    afterwards no ``repro`` module is loaded."""
    names = [_module_name(p) for p in PORT_FILES] + [p.stem for p in PORT_EXAMPLES]
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('imported', len(%r))\n" % (names,)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    assert f"imported {len(names)}" in res.stdout


SHARDED_MODULES = ["repro_torch.launch.mesh", "repro_torch.optim.grad_compress",
                   "repro_torch.optim.sharding_rules", "repro_torch.core.embedding",
                   "repro_torch.models.recsys", "repro_torch.ckpt.checkpoint",
                   "repro_torch.core.lookup_engine", "repro_torch.models.layers"]


REGISTRY_MODULES = ["repro_torch.configs", "repro_torch.configs.recsys_common",
                    "repro_torch.configs.dlrm_flexemr", "repro_torch.configs.wide_deep",
                    "repro_torch.configs.autoint", "repro_torch.configs.two_tower_retrieval",
                    "repro_torch.configs.dcn_v2", "repro_torch.configs.deepfm",
                    "repro_torch.configs.mind"]


MOE_LM_MODULES = ["repro_torch.models.moe", "repro_torch.models.transformer",
                  "repro_torch.configs.olmoe_1b_7b", "repro_torch.configs.arctic_480b",
                  "repro_torch.configs.qwen2_72b", "repro_torch.configs.llama3_405b"]


GNN_MODULES = ["repro_torch.models.gnn", "repro_torch.data.graph_sampler",
               "repro_torch.configs.graphsage_reddit"]


DRYRUN_MODULES = ["repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
                  "repro_torch.kernels.work"]


@pytest.mark.parametrize("name", SHARDED_MODULES + REGISTRY_MODULES + MOE_LM_MODULES
                         + GNN_MODULES + DRYRUN_MODULES)
def test_sharded_path_modules_are_checked(name):
    """The modules of the sharded path, of the config registry, of the
    MoE LM serving path, of the GNN and of the dry run are among those
    imported without jax above and scanned for imports below."""
    assert name in [_module_name(p) for p in PORT_FILES]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("name", DEMOS)
def test_demos_are_checked(name):
    """The five README demos of the port are among the examples imported
    without jax above and scanned for imports below."""
    assert name in [p.stem for p in PORT_EXAMPLES]


@pytest.mark.parametrize(
    "path", PORT_FILES + PORT_EXAMPLES + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("repro", "jax", "jaxlib"), f"{path.name} imports {mod}"


def _tiny_cfg():
    return R.RecsysConfig(
        name="t", arch="dlrm", tables=(TableSpec("a", 50, nnz=2),),
        embed_dim=8, n_dense=3, bottom_mlp=(8,), mlp=(8,),
    )


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")


def test_init_params_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        R.init_params(_tiny_cfg())


def test_server_raises_without_gpu(no_gpu):
    cfg = _tiny_cfg()
    params = R.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        FlexEMRServer(cfg, params, make_fused_tables(cfg.tables, cfg.embed_dim, 2))


def test_launch_serve_defaults_to_cuda_and_raises_without_gpu(no_gpu):
    args = launch_serve.parse_args(["--requests", "8", "--scale", "0.01"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        launch_serve.run(args)


def test_registry_smoke_defaults_to_cuda_and_raises_without_gpu(no_gpu):
    from repro_torch import configs

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        configs.get("mind").smoke()


def test_params_from_numpy_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        R.params_from_numpy({"w": np.zeros(3, np.float32)}, "cuda")


def _tiny_lm():
    return T.TransformerConfig(name="t", n_layers=2, d_model=16, n_heads=2,
                               n_kv_heads=1, d_ff=32, vocab=64, d_head=8)


def test_lm_init_params_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.init_params(_tiny_lm())


def test_lm_init_decode_cache_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.init_decode_cache(_tiny_lm(), batch=2, max_len=8)


def test_lm_params_from_numpy_raises_without_gpu(no_gpu):
    cfg = _tiny_lm()
    np_params = {k: v.numpy() for k, v in T.init_params(cfg, device="cpu").items()
                 if k != "layers"}
    np_params["layers"] = {"ln1": np.ones((2, 16), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        T.params_from_numpy(cfg, np_params, "cuda")


@pytest.mark.parametrize("name", DEMOS)
def test_demo_defaults_to_cuda_and_raises_without_gpu(name, no_gpu):
    """Each README demo runs on the card unless given ``--device cpu``."""
    import importlib

    sys.path.insert(0, str(ROOT / "examples"))
    demo = importlib.import_module(name)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        demo.main(["--requests", "8", "--scale", "0.01"] if name == "torch_serve_dlrm" else [])


def test_moe_init_raises_without_gpu(no_gpu):
    from repro_torch.models import moe

    cfg = moe.MoEConfig(num_experts=4, top_k=2, d_ff=8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        moe.moe_init(torch.Generator().manual_seed(0), cfg, d_model=8)


# ------------------------------------------------------- the package surface


def exported_names(init: Path) -> list[str]:
    """A package's exports, read from its ``__init__.py``: ``__all__``, else
    the public names it defines or imports from its own package."""
    names = []
    for node in ast.parse(init.read_text()).body:
        targets = [t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)]
        if "__all__" in targets:
            return [e.value for e in node.value.elts]
        if isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "repro":
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        names += targets
    return [n for n in names if not n.startswith("_")]


def _subpackage(init: Path) -> str:
    return ".".join(init.parent.relative_to(ROOT / "src" / "repro").parts)


@pytest.fixture(scope="module")
def port_surface() -> dict:
    """For each ``repro`` subpackage, the names it exports that its port
    counterpart lacks, read in one process with jax blocked."""
    wanted = {_subpackage(p): exported_names(p) for p in REF_INITS}
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"wanted = {wanted!r}\n"
        "out = {sub: [n for n in names if not hasattr("
        "importlib.import_module('repro_torch.' + sub), n)] for sub, names in wanted.items()}\n"
        "assert not [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("init", REF_INITS, ids=_subpackage)
def test_port_package_exports_the_reference_names(init, port_surface):
    """Every name a ``repro`` subpackage exports is importable from the
    port's package of the same name (``repro.core`` -> ``repro_torch.core``)."""
    assert port_surface[_subpackage(init)] == []


def test_kernel_names_are_entry_points_and_modules():
    """``repro_torch.kernels.flash_decode`` (and ``embedding_bag``,
    ``flash_attention``) is both the kernel's module, with its launch
    counter, and, called, the entry point ``ops.flash_decode``."""
    from repro_torch import kernels
    from repro_torch.kernels import embedding_bag, flash_decode, ops

    assert hasattr(flash_decode, "launches") and hasattr(embedding_bag, "launches_masked")
    g = torch.Generator().manual_seed(0)
    q, kc, vc = (torch.randn(s, generator=g) for s in ((2, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    n = torch.tensor([11], dtype=torch.int32)
    assert torch.equal(kernels.flash_decode(q, kc, vc, n), ops.flash_decode(q, kc, vc, n))
    table = torch.randn((50, 8), generator=g)
    ids = torch.randint(0, 50, (12,), generator=g, dtype=torch.int32)
    w = torch.rand(12, generator=g)
    assert torch.equal(embedding_bag(table, ids, w, 4), ops.embedding_bag(table, ids, w, 4))


def _serve_doc_commands() -> list[list[str]]:
    """The command lines of ``examples/torch_serve_dlrm.py``'s docstring:
    continuation lines joined, comments dropped, the arguments after the
    script."""
    doc = ast.get_docstring(ast.parse((ROOT / "examples" / "torch_serve_dlrm.py").read_text()))
    cmds, cur = [], ""
    for line in doc.splitlines():
        line = line.split("#")[0].strip()
        if cur:
            cur += " " + line
        elif "examples/torch_serve_dlrm.py" in line:
            cur = line
        if cur and not cur.endswith("\\"):
            cmds.append(shlex.split(cur.replace("\\", " ")))
            cur = ""
    return [c[c.index("examples/torch_serve_dlrm.py") + 1:] for c in cmds]


def test_serve_demo_accepts_its_docstring_commands():
    """Each command line in ``torch_serve_dlrm.py``'s docstring parses with
    the port's ``launch.serve`` flags."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_serve_dlrm

    cmds = _serve_doc_commands()
    assert len(cmds) == 8
    for argv in cmds:
        args = torch_serve_dlrm.parse_args(argv)
        assert args.requests in (1000, 2000, 200)
    assert torch_serve_dlrm.parse_args(cmds[-1]).device == "cpu"
    assert torch_serve_dlrm.parse_args(cmds[-2]).degrade_policy == "degrade"
