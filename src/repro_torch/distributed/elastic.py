"""Elastic scaling: re-shard a run onto a different mesh (port of
``repro/distributed/elastic.py``).

A node drops out, the scheduler hands back a smaller (or later, larger)
set of devices, and training resumes from the last checkpoint re-sharded
onto the new mesh.  Checkpoints hold gathered leaves
(``checkpoint/ckpt.py``) and specs are derived from the full parameter
shapes and the *current* mesh (``distributed/sharding.py``), so the
re-shard is one ``shard_leaf`` per leaf -- any mesh shape to any other.

``replan_mesh`` is the reference's shrink/grow policy, pure integer
arithmetic: keep the model axis (the tensor-parallel degree is fixed by
memory), absorb node loss into the data axis, and keep the global batch
divisible (the gradient-accumulation factor adjusts to preserve the
effective batch).
"""

from __future__ import annotations

import dataclasses

from repro_torch.checkpoint import ckpt
from repro_torch.distributed.sharding import param_shardings


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    microbatches: int          # grad-accum factor preserving effective batch
    note: str = ""


def replan_mesh(devices_available: int, model_parallel: int,
                global_batch: int, base_microbatches: int = 1,
                pods: int = 1) -> ElasticPlan:
    """Shrink/grow policy: fix the model axis, flex the data axis."""
    if devices_available % (model_parallel * pods):
        # drop stragglers until divisible (documented policy: round down)
        devices_available -= devices_available % (model_parallel * pods)
    data_max = devices_available // (model_parallel * pods)
    if data_max < 1:
        raise ValueError("not enough devices for the model-parallel degree")
    # the data axis must evenly split the global batch; round DOWN to the
    # largest divisor -- idling a few hosts beats uneven per-replica batches
    data = data_max
    while data > 1 and global_batch % (data * pods):
        data -= 1
    # grad accumulation preserves the per-step effective batch
    micro = base_microbatches
    while global_batch % (data * pods * micro) and micro < global_batch:
        micro += 1
    shape = (pods, data, model_parallel) if pods > 1 else (data,
                                                           model_parallel)
    names = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return ElasticPlan(shape, names, micro,
                       note=f"data axis {data} (of {data_max} available), "
                            f"accum x{micro}")


def restore_on_mesh(directory: str, step: int, abstract_params, mesh,
                    device=None):
    """Checkpoint ``step`` (written at any mesh, or none) -> (this rank's
    blocks of every leaf on ``mesh``, extra).  ``abstract_params``: the
    full tree's shapes and dtypes (``meta`` tensors will do)."""
    shardings = param_shardings(abstract_params, mesh)
    return ckpt.restore(directory, step, abstract_params, device,
                        shardings=shardings, mesh=mesh)


__all__ = ["ElasticPlan", "replan_mesh", "restore_on_mesh"]
