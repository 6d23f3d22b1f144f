"""The port's cluster controller (``k8s_dra_driver_tpu/controller``): the
slice manager, lease-based leader election and the controller binary."""
