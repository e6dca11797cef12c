"""Kernels written by hand for Hopper, each module holding one kernel's
wrapper (with its launch counter) beside its plain PyTorch version."""
