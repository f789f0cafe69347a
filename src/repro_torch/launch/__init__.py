"""Launch: the data-parallel mesh and the (pod, data, cp, model) grid (``mesh.py``)."""

from .mesh import (DataMesh, GridMesh, ModelRing, batch_axes_for, cp_size, data_mesh,
                   init_data_mesh, init_grid_mesh, model_size, pod_size, rank_microbatches)

__all__ = ["DataMesh", "GridMesh", "ModelRing", "batch_axes_for", "cp_size", "data_mesh",
           "init_data_mesh", "init_grid_mesh", "model_size", "pod_size",
           "rank_microbatches"]
