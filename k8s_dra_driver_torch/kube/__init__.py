"""The port of ``k8s_dra_driver_tpu/kube/__init__.py`` (copied: the port imports
nothing of the JAX package).

Minimal Kubernetes object model, in-memory API server and helpers.

The reference consumes these through client-go and the vendored
``k8s.io/dynamic-resource-allocation`` helpers (SURVEY.md §2.5).  This package
re-provides the behavioral surface the driver needs — typed objects with
camelCase JSON round-tripping, an API client interface, an in-memory API server
with watch support for tests/benches, and the declarative ResourceSlice
reconciler — without depending on a running cluster.
"""
