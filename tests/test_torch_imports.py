"""repro_torch stands alone: it imports neither jax nor the JAX package, and
its entry points refuse to fall back to the CPU when a GPU was asked for."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.sharding import TableSpec, make_fused_tables
from repro_torch.launch import serve as launch_serve
from repro_torch.models import recsys as R
from repro_torch.runtime.serving import FlexEMRServer

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py"))


def _module_name(path: Path) -> str:
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_every_module_imports_without_jax():
    """Each module imports with ``sys.modules["jax"] = None`` (any jax import
    then raises), and afterwards no ``repro`` module is loaded."""
    names = [_module_name(p) for p in PORT_FILES]
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
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


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize(
    "path", PORT_FILES + [ROOT / "chip_smoke.py"],
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


def test_params_from_numpy_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        R.params_from_numpy({"w": np.zeros(3, np.float32)}, "cuda")
