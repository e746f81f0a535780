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
"""
