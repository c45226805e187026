"""Mesh construction (port of ``repro/launch/mesh.py``).

A FUNCTION, not a module-level constant: importing this module touches no
device or process group.  A mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group, with the reference's axis
names: ``("data", "model")``, or ``("pod", "data", "model")`` with pods.
The caller joins the process group first (``torchrun`` and
``init_process_group``: NCCL on the card, gloo on the CPU), one rank a
device.

The production shapes, 16 x 16 and 2 x 16 x 16, are given as shapes and
names only (``production_mesh_shape``): a ``DeviceMesh`` of 256 or 512
ranks needs that many processes, so the dry-run that lowers against them
decides how to stand in for the ranks.
"""

from __future__ import annotations


def production_mesh_shape(*, multi_pod: bool = False):
    """-> (shape, axis names): 16 x 16 = 256 chips per pod; ``multi_pod``
    adds the 2-pod outer axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def mesh_shape_for(devices: int, model_parallel: int = 1, pods: int = 1):
    """-> (shape, axis names) of ``make_mesh_for``'s mesh."""
    data = devices // (model_parallel * pods)
    if data * model_parallel * pods != devices or data < 1:
        raise ValueError(f"{devices} devices do not split into {pods} "
                         f"pod(s) x model {model_parallel}")
    if pods > 1:
        return (pods, data, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def make_mesh_for(devices: int, model_parallel: int = 1, pods: int = 1,
                  device_type: str = "cuda"):
    """The (data, model) -- or (pod, data, model) -- ``DeviceMesh`` over
    ``devices`` ranks of the default process group (its world size must be
    ``devices``); the model axis innermost, so a model group is
    ``model_parallel`` consecutive ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_shape_for(devices, model_parallel, pods)
    if not dist.is_initialized() or dist.get_world_size() != devices:
        world = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a mesh of {devices} devices needs a process "
                           f"group of {devices} ranks (have {world}); start "
                           f"one rank a device, e.g. under torchrun")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


__all__ = ["production_mesh_shape", "mesh_shape_for", "make_mesh_for"]
