"""Launch: the data-parallel mesh and the (pod, data, cp, model) grid
(``mesh.py``), the step builder (``stepbuilder.py``), the dry run
(``dryrun.py``, run as ``python -m repro_torch.launch.dryrun``: its
``default_plan``, ``plan_from_args``, ``run_one`` and the estimator under
them, ``estimate``) and the training CLI (``train.py``, run as ``python -m
repro_torch.launch.train``; it exports nothing here).

The step builder's and the dry run's names are loaded on first use: they
build models, which import this package's mesh."""

from .mesh import (DataMesh, GridMesh, ModelRing, batch_axes_for, cp_size, data_mesh,
                   init_data_mesh, init_grid_mesh, model_size, pod_size, rank_microbatches)

_STEPBUILDER = ("build_step", "resolve_config", "skip_reason")
_DRYRUN = ("default_plan", "estimate", "plan_from_args", "run_one")


def __getattr__(name):
    if name in _STEPBUILDER:
        from . import stepbuilder  # noqa: PLC0415 (import cycle: models import .mesh)
        return getattr(stepbuilder, name)
    if name in _DRYRUN:
        from . import dryrun  # noqa: PLC0415 (the same cycle)
        return getattr(dryrun, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DataMesh", "GridMesh", "ModelRing", "batch_axes_for", "build_step", "cp_size",
           "data_mesh", "default_plan", "estimate", "init_data_mesh", "init_grid_mesh",
           "model_size", "plan_from_args", "pod_size", "rank_microbatches", "resolve_config",
           "run_one", "skip_reason"]
