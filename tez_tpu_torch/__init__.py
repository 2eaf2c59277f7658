"""tez_tpu_torch: the PyTorch + CUDA port of tez_tpu's data plane.

The package mirrors tez_tpu's module names (``ops/device.py``,
``ops/sorter.py``, ...) so each counterpart is easy to find, but imports
nothing of ``tez_tpu`` and nothing of JAX: it keeps its own copy of every
helper it needs.  Tensor code is PyTorch; the two TPU Pallas kernels
(``tez_tpu/ops/pallas_kernels.py``) are hand-written CUDA C++ for sm_90a
under ``csrc/``, built with nvcc on first use (``ops/_build.py``) and bound
in ``ops/kernels.py`` beside their plain PyTorch versions.

Entry points take ``device="cuda"`` by default; only a caller that passes
``device="cpu"`` runs on the host (the kernels' plain versions).
"""
