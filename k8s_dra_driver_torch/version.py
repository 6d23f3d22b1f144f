"""Version stamping (``k8s_dra_driver_tpu/version.py``, copied: the
checkpoint's ``writerVersion`` is this version, so the port's checkpoint
bytes equal the reference's)."""

__version__ = "0.1.0"


def version_string() -> str:
    return f"tpu-dra-driver {__version__}"
