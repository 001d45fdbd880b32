"""PyTorch / CUDA port of the k-priority scheduling system (``src/repro/`` is
the JAX reference). Module names mirror the reference package; this package
imports ``torch`` and numpy only.

Entry points take ``device=`` (default ``"cuda"``, which raises without a
GPU). The one hand-written kernel of the scheduler path is the relaxed
top-k selection in ``kernels/csrc/relaxed_topk.cu``; it is compiled with
``nvcc`` at first use (``kernels/_build.py``).
"""
from repro_torch.device import resolve_device  # noqa: F401
