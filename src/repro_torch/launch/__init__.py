"""Launch: the data-parallel mesh and the (pod, data, cp, model) grid
(``mesh.py``), the step builder (``stepbuilder.py``) and the training CLI
(``train.py``, run as ``python -m repro_torch.launch.train``; it exports
nothing here).

The step builder's names are loaded on first use: it builds models, which
import this package's mesh."""

from .mesh import (DataMesh, GridMesh, ModelRing, batch_axes_for, cp_size, data_mesh,
                   init_data_mesh, init_grid_mesh, model_size, pod_size, rank_microbatches)

_STEPBUILDER = ("build_step", "resolve_config", "skip_reason")


def __getattr__(name):
    if name in _STEPBUILDER:
        from . import stepbuilder  # noqa: PLC0415 (import cycle: models import .mesh)
        return getattr(stepbuilder, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DataMesh", "GridMesh", "ModelRing", "batch_axes_for", "build_step", "cp_size",
           "data_mesh", "init_data_mesh", "init_grid_mesh", "model_size", "pod_size",
           "rank_microbatches", "resolve_config", "skip_reason"]
