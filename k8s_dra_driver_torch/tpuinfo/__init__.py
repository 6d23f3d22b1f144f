"""Card enumeration (``tpuinfo/binding.py`` over the native shim in
``tpuinfo/cpp``) and the card's runtime self-test
(``tpuinfo/selftest.py``)."""
