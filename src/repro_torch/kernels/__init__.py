"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  embedding_bag    — K1, fused gather + weighted pool (csrc/embedding_bag.cu)
  dot_interaction  — K2, DLRM pairwise-dot gram matrix (csrc/dot_interaction.cu)

``ops.py`` holds the entry points (dispatch by device), ``ref.py`` the plain
versions, ``build.py`` the nvcc/ctypes build.  Importing this package builds
nothing; a kernel builds at its first launch.
"""
