"""PyTorch/CUDA port of the serving compute stack of ``k8s_dra_driver_tpu``.

The package mirrors the JAX package's module paths one for one
(``k8s_dra_driver_torch/models/paged.py`` is the counterpart of
``k8s_dra_driver_tpu/models/paged.py``).  It imports torch and numpy only:
nothing of JAX and nothing of the JAX package.  Kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` on first use
(``ops/_build.py``); on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""
