"""Launch: the data-parallel mesh (``mesh.py``)."""

from .mesh import DataMesh, batch_axes_for, init_data_mesh, rank_microbatches

__all__ = ["DataMesh", "batch_axes_for", "init_data_mesh", "rank_microbatches"]
