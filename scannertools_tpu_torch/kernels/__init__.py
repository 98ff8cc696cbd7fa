"""Hand-written CUDA kernels of scannertools_tpu_torch: sources under
``csrc/``, built and loaded by ``build.py``; the wrappers live beside the
ops that use them."""
