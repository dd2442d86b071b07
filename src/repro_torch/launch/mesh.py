"""Production mesh construction.

FUNCTIONS, not module-level constants: importing this module touches no
distributed state. The caller owns the process group (NCCL on the cards,
`gloo` or `fake` on the host) and starts it before asking for a mesh of its
world size. Counterpart of src/repro/launch/mesh.py, with its shapes and
axis names, as `init_device_mesh` meshes.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod.

    Axis roles (see distributed/sharding.py):
      pod  — data parallel across pods (gradient sync over DCI)
      data — DP/FSDP within a pod
      model — tensor/expert parallel (heads, ffn, experts, decode kv-seq)
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(*, multi_pod: bool = False,
                    device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for CI-scale sharding validation (2x2 / 2x2x2)."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
