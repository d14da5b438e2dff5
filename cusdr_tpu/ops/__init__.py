"""Accelerator kernels: the fused GPU epoch correlator (correlator.py)."""
