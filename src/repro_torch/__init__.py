"""repro_torch — the FlexEMR reproduction in PyTorch, with CUDA kernels for Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
file for file (``repro/hotcache/miss_path.py`` -> ``repro_torch/hotcache/
miss_path.py``) and never imports ``jax`` or anything of ``repro``.  The
numpy-only host modules (obs, rdma, data, the host tier of hotcache and core)
are copies with their imports rewritten; the device side (kernels, models,
core.embedding, runtime.serving) is written anew in torch.

Every Pallas TPU kernel on a ported path becomes a CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use and loaded with
``ctypes`` (``kernels.build``).  A wrapper launches its kernel for a CUDA
tensor and takes the plain PyTorch version (``kernels.ref``) only for a CPU
tensor; entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no GPU is present.

``repro/compat.py`` (the shim over jax versions) has no counterpart here.
"""
