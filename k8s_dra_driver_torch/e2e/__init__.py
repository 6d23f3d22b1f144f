"""End-to-end entry points of the port (``k8s_dra_driver_tpu/e2e``): the
multi-card dry run, ``python -m k8s_dra_driver_torch.e2e.dryrun N``."""
