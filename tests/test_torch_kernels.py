"""repro_torch kernels K1 (embedding bag) and K2 (dot interaction) against the
JAX package's Pallas kernels in interpret mode, over the sweeps of
tests/test_kernels.py.

On the CPU the port's entry points take the plain PyTorch versions
(kernels/ref.py); the CUDA kernels themselves are held against those plain
versions on the card by chip_smoke.py.  Tolerances are the reference's own:
f32 1e-5; bf16 2e-2 (bag) and 3e-2 (gram), since the two sides round the
bf16 inputs identically but sum in different orders.
"""
import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dot_interaction import dot_interaction as jax_dot
from repro.kernels.embedding_bag import embedding_bag as jax_bag
from repro.kernels.ops import bag_lookup as jax_bag_lookup
from repro.kernels.ops import dot_interaction_triu as jax_triu
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import dot_interaction as K2
from repro_torch.kernels import embedding_bag as K1

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _pair(a: np.ndarray, jdt, tdt):
    """The same numpy values as a jax array and a torch tensor of one dtype
    (both round f32 -> bf16 to nearest even)."""
    a32 = np.asarray(a, np.float32)
    return jnp.asarray(a32, jdt), torch.from_numpy(a32).to(tdt)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "V,D,bags,nnz", [(64, 128, 4, 1), (200, 128, 16, 4), (512, 256, 8, 8)]
)
def test_embedding_bag_matches_pallas(dtypes, V, D, bags, nnz, rng):
    jdt, tdt = dtypes
    table_j, table_t = _pair(rng.normal(size=(V, D)), jdt, tdt)
    idx = rng.integers(0, V, bags * nnz).astype(np.int32)
    w = (rng.random(bags * nnz) > 0.25).astype(np.float32)
    want = jax_bag(table_j, jnp.asarray(idx), jnp.asarray(w), bags, interpret=True)
    got = ops.embedding_bag(table_t, torch.from_numpy(idx), torch.from_numpy(w), bags)
    assert got.dtype == torch.float32 and got.shape == (bags, D)
    tol = 1e-5 if tdt == torch.float32 else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_bag_lookup_matches_pallas(rng):
    table = rng.normal(size=(100, 128)).astype(np.float32)
    idx = rng.integers(0, 100, (4, 3, 2)).astype(np.int32)
    msk = rng.random((4, 3, 2)) > 0.3
    want = jax_bag_lookup(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(msk),
                          interpret=True)
    got = ops.bag_lookup(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(msk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,F,D,blk", [(8, 7, 32, 4), (16, 27, 64, 8), (4, 40, 16, 4),
                                       (64, 17, 64, 16), (6, 41, 64, 3)])
def test_dot_interaction_matches_pallas(dtypes, B, F, D, blk, rng):
    """The reference's sweep plus the serve shape [64, 17, 64] and F = 41, the
    widest paper config, which neither 3 nor 4 divides: the shapes whose rows
    the kernel pads to its 4-row register tiles."""
    jdt, tdt = dtypes
    x_j, x_t = _pair(rng.normal(size=(B, F, D)), jdt, tdt)
    want = jax_dot(x_j, block_b=blk, interpret=True)
    got = ref.dot_interaction_ref(x_t)
    assert got.dtype == torch.float32 and got.shape == (B, F, F)
    tol = 1e-5 if tdt == torch.float32 else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,F,D", [(4, 5, 16), (3, 17, 64)])
def test_dot_interaction_triu_matches_pallas(B, F, D, rng):
    """Same row-major triu order as np.triu_indices (torch.triu_indices)."""
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    want = jax_triu(jnp.asarray(x), interpret=True)
    got = ops.dot_interaction_triu(torch.from_numpy(x))
    assert got.shape == (B, F * (F + 1) // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_never_launch(rng):
    """CPU tensors take the plain versions: the launch counters stay put."""
    before = (K1.launches, K2.launches)
    table = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, (6, 3, 2)).astype(np.int32))
    msk = torch.from_numpy(rng.random((6, 3, 2)) > 0.5)
    ops.bag_lookup(table, idx, msk)
    ops.dot_interaction_triu(torch.randn(6, 4, 16))
    assert (K1.launches, K2.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises; it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA"):
        K1.embedding_bag(torch.zeros(4, 8), torch.zeros(4, dtype=torch.int32),
                         torch.ones(4), 2)
    with pytest.raises(ValueError, match="CUDA"):
        K2.dot_interaction(torch.zeros(2, 3, 8))


def test_ops_reject_other_devices():
    """A device other than cuda, cpu and meta (the dry run's) raises, and so
    do tensors on two kinds of device."""
    with pytest.raises(ValueError, match="unsupported device"):
        ops.dot_interaction_triu(types.SimpleNamespace(device=torch.device("xpu"),
                                                       requires_grad=False))
    with pytest.raises(ValueError, match="one device type"):
        ops.embedding_bag(torch.zeros(4, 8, device="meta"), torch.zeros(4, dtype=torch.int32),
                          torch.ones(4), 2)


@pytest.mark.parametrize("mod", [K1, K2], ids=["embedding_bag", "dot_interaction"])
def test_bound_symbols_exist_in_source(mod):
    """Every C function a wrapper binds is exported by its .cu source, and
    the library name carries a hash of that source."""
    src = (build.CSRC / f"{mod.NAME}.cu").read_text()
    exported = set(re.findall(r"^(?:int|const char\*) (\w+)\(", src, re.M))
    assert set(mod._SYMBOLS.values()) | {f"{mod.NAME}_error_string"} <= exported
    path = build.library_path(mod.NAME)
    assert path.parent == build.BUILD_DIR
    assert re.fullmatch(rf"lib{mod.NAME}-[0-9a-f]{{16}}\.so", path.name)


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose data starts 2 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=dtype)
    step = 2 // flat.element_size() or 1
    return flat[step:step + n].view(shape)


@pytest.mark.parametrize(
    "x,exc,match",
    [
        (torch.zeros(2, 3, 8, dtype=torch.float16), TypeError, "dtype"),
        (torch.zeros(6, 8), ValueError, "want a contiguous"),
        (torch.zeros(2, 8, 3).transpose(1, 2), ValueError, "want a contiguous"),
        (torch.zeros(2, 3, 6), ValueError, "multiple of 16 bytes"),
        (torch.zeros(2, 3, 12, dtype=torch.bfloat16), ValueError, "multiple of 16 bytes"),
        (_misaligned((2, 3, 8), torch.bfloat16), ValueError, "16-byte boundary"),
        (torch.zeros(1, 64, 1024), ValueError, "shared memory"),
    ],
    ids=["f16", "rank", "strided", "row-f32", "row-bf16", "misaligned", "too-large"],
)
def test_dot_interaction_refuses_bad_input(x, exc, match):
    """Every input the kernel cannot take raises in the wrapper, before any
    launch (the CPU tensors here never reach the device check)."""
    before = K2.launches
    with pytest.raises(exc, match=match):
        K2.dot_interaction(x)
    assert K2.launches == before


@pytest.mark.parametrize("F,D,itemsize,want", [(27, 64, 4, 18148), (17, 64, 2, 6916),
                                               (40, 512, 4, 171520), (41, 64, 4, 30660)])
def test_dot_interaction_sample_smem(F, D, itemsize, want):
    """Two buffers of F rows padded to a multiple of 4, each row an odd count
    of 16-byte vectors, plus the [F, F] f32 result: the serve bucket, the
    forward's samples and [3, 40, 512] fit a block; F = 64, D = 1024 does not."""
    assert K2.sample_smem_bytes(F, D, itemsize) == want <= K2.MAX_SMEM
    assert K2.sample_smem_bytes(64, 1024, 4) > K2.MAX_SMEM
    K2.check_inputs(torch.zeros(3, 40, 512))  # chip_smoke.py's largest sample


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """An edit to a header that a source includes, directly or through another
    header, changes the library's path (so a stale build is never loaded);
    an edit to a header it does not include leaves the path alone."""
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\nint k_fn();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


def test_use_library_replaces_the_build(tmp_path, monkeypatch):
    """After ``use_library`` the wrapper's ``load`` opens the given library,
    once, with the wrapper's signatures, and builds nothing."""
    opened = []

    class Lib:
        def __init__(self, path):
            opened.append(path)
            self.k_fn = types.SimpleNamespace()
            self.k_error_string = types.SimpleNamespace()

    def no_build(names, ptxas_verbose=False):
        raise AssertionError(f"built {names}")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_paths", {})
    build.use_library("k", tmp_path / "libk-variant.so")
    lib = build.load("k", {"k_fn": [ctypes.c_int]})
    assert build.load("k", {"k_fn": [ctypes.c_int]}) is lib
    assert opened == [str(tmp_path / "libk-variant.so")]
    assert lib.k_fn.argtypes == [ctypes.c_int] and lib.k_fn.restype is ctypes.c_int
