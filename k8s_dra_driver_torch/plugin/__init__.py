"""The driver's node half: the kubelet plugin's core (``k8s_dra_driver_tpu/plugin/``)."""
