"""Production meshes: the port's counterpart of ``repro.launch.mesh``.

Defined as functions, so importing this module touches no device and no
process group.

  single-pod: (16, 16)    axes ("data", "model")        = 256 ranks
  multi-pod:  (2, 16, 16) axes ("pod", "data", "model") = 512 ranks

"model" maps to the TP/EP/SP group, "data" to the DP/FSDP group, "pod" to
pure DP across pods. ``abstract=True`` gives the ``AbstractMesh`` of the
same shape (axis names and sizes, no devices), which the LM dry run
reckons against. Otherwise the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the current process
group, which must hold exactly that many ranks: ``init_device_mesh``
raises when it does not.
"""

from __future__ import annotations

from repro_torch.sharding.logical import AbstractMesh


def make_production_mesh(multi_pod: bool = False, abstract: bool = False,
                         device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if abstract:
        return AbstractMesh(shape, axes)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device: str = "cuda"):
    """A (world // model, model) ("data", "model") mesh over the current
    process group (tests, the CPU with ``device="cpu"`` and gloo, one
    card with nccl)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))
