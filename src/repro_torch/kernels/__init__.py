"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  embedding_bag    — K1, fused gather + weighted pool (csrc/embedding_bag.cu)
  dot_interaction  — K2, DLRM pairwise-dot gram matrix (csrc/dot_interaction.cu)
  flash_attention  — K6, causal/full GQA attention forward (csrc/flash_attention.cu)
  flash_decode     — K7, one query token against a KV cache (csrc/flash_decode.cu)

``ops.py`` holds the entry points (dispatch by device), ``ref.py`` the plain
versions, ``build.py`` the nvcc/ctypes build.  Importing this package builds
nothing; a kernel builds at its first launch.  The other kernels sit with
the subsystem they serve: K3 ``probe_gather_pool`` and K4 ``scatter_update``
in ``hotcache/kernels.py``, K5 ``topk_neighbor_select`` in
``prefetch/kernels.py``; their sources are in ``csrc/`` too.

The names below are the reference package's ``repro.kernels`` surface.
Three of them are also submodules here (``embedding_bag``,
``flash_attention``, ``flash_decode``: a kernel's wrapper, launch counters
and work), and ``from repro_torch.kernels import flash_decode`` finds the
submodule: each of the three is made callable, a call running the entry
point of its name in ``ops``.
"""
import sys
import types

from repro_torch.kernels.ops import bag_lookup, dot_interaction_triu


class _EntryPointModule(types.ModuleType):
    """A kernel's module that, called, runs ``ops.<its name>``."""

    def __call__(self, *args, **kwargs):
        from repro_torch.kernels import ops

        return getattr(ops, self.__name__.rpartition(".")[2])(*args, **kwargs)


for _name in ("embedding_bag", "flash_attention", "flash_decode"):
    sys.modules[f"{__name__}.{_name}"].__class__ = _EntryPointModule
from repro_torch.kernels import embedding_bag, flash_attention, flash_decode  # noqa: E402

__all__ = [
    "bag_lookup",
    "dot_interaction_triu",
    "embedding_bag",
    "flash_attention",
    "flash_decode",
    "probe_gather_pool",
    "scatter_update",
]

# ``hotcache.kernels`` imports this package's modules: its two names load on
# first use (PEP 562), or importing ``repro_torch.hotcache`` first would meet
# a partly initialised ``hotcache.kernels``.
_HOTCACHE_NAMES = ("probe_gather_pool", "scatter_update")


def __getattr__(name: str):
    if name in _HOTCACHE_NAMES:
        from repro_torch.hotcache import kernels

        return getattr(kernels, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
