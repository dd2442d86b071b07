"""Attention and MoE expert kernels: CUDA C++ for Hopper under `csrc/`,
their ctypes wrappers, the plain PyTorch versions (`ref`, and
`models.layers.moe_apply_ref`), the device dispatch (`ops`) and the launch
and call counters (`counts`).
"""
