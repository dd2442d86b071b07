"""Attention kernels: CUDA C++ for Hopper under `csrc/`, their ctypes
wrappers, the plain PyTorch versions (`ref`), the device dispatch (`ops`)
and the launch and call counters (`counts`).
"""
