"""End-to-end entry points of the port (``k8s_dra_driver_tpu/e2e``): the
multi-card dry run, ``python -m k8s_dra_driver_torch.e2e.dryrun N``; the
closed-loop cluster (``harness.py``: the in-memory API server, the
allocator standing in for kube-scheduler, one port ``Driver`` a host) and
the quickstart spec runner (``spec_runner.py``: ``apply_spec``)."""
