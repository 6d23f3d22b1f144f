"""PyTorch/CUDA port of ``k8s_dra_driver_tpu``.

The package mirrors the JAX package's module paths one for one
(``k8s_dra_driver_torch/models/paged.py`` is the counterpart of
``k8s_dra_driver_tpu/models/paged.py``).  It imports torch and numpy only:
nothing of JAX and nothing of the JAX package.  Kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` on first use
(``ops/_build.py``); on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.  The driver's node half (``kube/``, ``api/``,
``plugin/``, ``tpuinfo/binding.py``) keeps the reference's names, so a
claim prepared here wires the same ``TPU_*`` environment.
"""

from k8s_dra_driver_torch.version import __version__

DRIVER_NAME = "tpu.google.com"
"""DNS-style driver name used in DeviceClasses, ResourceSlices and CDI kinds
(the reference's, kept: claims and CDI ids name it)."""

__all__ = ["DRIVER_NAME", "__version__"]
