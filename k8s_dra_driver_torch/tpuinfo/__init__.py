"""The card's runtime self-test (``tpuinfo/selftest.py``); the
reference's ``tpuinfo`` C++ shim and its binding enumerate TPU chips and
have no counterpart here."""
