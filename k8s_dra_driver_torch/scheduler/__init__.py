"""kube-scheduler's stand-in (``k8s_dra_driver_tpu/scheduler``): the CEL
subset of device selectors (``cel.py``), the versioned allocation index
(``index.py``) and the structured-parameter allocator (``allocator.py``)."""
