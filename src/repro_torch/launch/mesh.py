"""The data-parallel mesh on ``torch.distributed`` (the port of the reference's
``data`` mesh axis, ``repro/launch/mesh.py``).

:class:`DataMesh` is what the port passes as ``mesh=`` wherever the reference
takes a mesh. Its ``shape`` is the reference mesh's contract, ``{"data": n}``,
which the layout rules and the checkpoint manifest read; it also holds the
process group, this process's rank, its device and the collectives the train
step and the checkpoint layer run.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU tensors.
:func:`init_data_mesh` may be asked for gloo by name on CUDA: gloo is a host
library, so the mesh's transport is then ``"host"``: each collective copies its
device tensors to the host, runs there and copies the result back. That is
the transport of two ranks on one card (NCCL refuses two ranks on one device)
and is slow by construction. Otherwise the transport is ``"direct"``: the
backend reads the tensors where they are.

Each rank also gets a second gloo group, ``host_group``, for host-side traffic
of its own (the checkpoint's gather of moment shards), so that traffic never
interleaves with the step's collectives on the main group.

Launch, one process per rank: under ``torchrun`` call
``init_data_mesh(device=f"cuda:{local_rank}")`` (rank, world size and the
address come from the environment); elsewhere pass ``init_method``
(``"file:///path"`` or ``"tcp://localhost:PORT"``), ``rank`` and
``world_size``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device


class DataMesh:
    """One ``data`` axis over the ranks of ``group`` (every rank of the world
    when ``group`` is the default group). ``group=None`` is the mesh of one
    process, with no process group: its collectives are identities.

    The means are a SUM, then a division by the size (gloo has no AVG). The
    collectives add their wall time to ``seconds[kind]``; with
    ``timed`` set they first wait for the device, so that time is the
    collective's own."""

    def __init__(self, group=None, device: Union[str, torch.device] = "cpu", *,
                 host_group=None):
        self.group = group
        self.host_group = host_group
        self.device = torch.device(device)
        self.size = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.backend = dist.get_backend(group) if group is not None else None
        # gloo is a host library: device tensors go through host copies
        self.transport = ("host" if self.backend == "gloo" and self.device.type == "cuda"
                          else "direct")
        self.timed = False
        self.seconds: Dict[str, float] = {"reduce_scatter": 0.0, "all_gather": 0.0,
                                          "all_reduce": 0.0}

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def __repr__(self) -> str:
        return (f"DataMesh(data={self.size}, rank={self.rank}, backend={self.backend}, "
                f"transport={self.transport}, device={self.device})")

    # -- collectives ---------------------------------------------------------

    def _sync(self):
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, kind: str, op, out: torch.Tensor, inp: torch.Tensor) -> None:
        """``op(out, inp)`` on the main group (``out is inp`` for an in-place
        collective), through host copies on the host transport."""
        self._sync()
        t0 = time.perf_counter()
        if self.transport == "host":
            h_in = inp.cpu()
            h_out = h_in if out is inp else torch.empty(out.shape, dtype=out.dtype)
            op(h_out, h_in)
            out.copy_(h_out)
        else:
            op(out, inp)
        self._sync()
        self.seconds[kind] += time.perf_counter() - t0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (contiguous) replaced in place by its sum over the ranks."""
        if self.group is not None:
            self._run("all_reduce", lambda o, _: dist.all_reduce(o, group=self.group), t, t)
        return t

    def all_reduce_int(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` (contiguous int64, a few scalars: the integrity audit's
        checksums) replaced in place by its ``op`` ("sum", "max" or "min")
        over the ranks."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        if self.group is not None:
            self._run("all_reduce",
                      lambda o, _: dist.all_reduce(o, op=red, group=self.group), t, t)
        return t

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (contiguous) replaced in place by its mean over the ranks."""
        return self.all_reduce_sum(t).div_(self.size)

    def reduce_scatter_mean(self, inp: torch.Tensor) -> torch.Tensor:
        """This rank's block of dim 0 of the mean of ``inp`` (contiguous, dim 0
        divisible by the size) over the ranks: a new tensor."""
        out = torch.empty((inp.shape[0] // self.size,) + tuple(inp.shape[1:]),
                          dtype=inp.dtype, device=inp.device)
        if self.group is None:
            return out.copy_(inp)
        self._run("reduce_scatter",
                  lambda o, i: dist.reduce_scatter_tensor(o, i, group=self.group), out, inp)
        return out.div_(self.size)

    def all_gather(self, inp: torch.Tensor) -> torch.Tensor:
        """Every rank's ``inp`` (contiguous, the same shape on each), stacked
        along dim 0 in rank order: a new tensor."""
        out = torch.empty((inp.shape[0] * self.size,) + tuple(inp.shape[1:]),
                          dtype=inp.dtype, device=inp.device)
        if self.group is None:
            return out.copy_(inp)
        self._run("all_gather", lambda o, i: dist.all_gather_into_tensor(o, i, group=self.group), out, inp)
        return out

    def barrier_error(self, failed: bool) -> bool:
        """Whether any rank of ``host_group`` passed ``failed``: a barrier that
        also spreads one rank's failure to all."""
        if self.host_group is None:
            return failed
        flag = torch.tensor([1 if failed else 0], dtype=torch.int32)
        dist.all_reduce(flag, group=self.host_group)
        return bool(flag.item())

    def close(self) -> None:
        """Leave the process group (``dist.destroy_process_group``)."""
        if self.group is not None:
            dist.destroy_process_group()
            self.group = self.host_group = None


def init_data_mesh(device: Optional[Union[str, torch.device]] = None, *,
                   backend: Optional[str] = None, init_method: str = "env://",
                   rank: Optional[int] = None, world_size: Optional[int] = None) -> DataMesh:
    """Join the process group and return this rank's :class:`DataMesh`.
    ``device`` defaults to the CUDA card (``resolve_device``); ``backend`` to
    NCCL on CUDA and gloo on the CPU. gloo on CUDA selects the host transport
    (module docstring); NCCL on the CPU raises."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL moves CUDA tensors; a CPU mesh takes gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {} if rank is None else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return DataMesh(dist.group.WORLD, device, host_group=dist.new_group(backend="gloo"))


def batch_axes_for(mesh, global_batch: int) -> Tuple[str, ...]:
    """The reference's rule (``repro/launch/mesh.py:67``) on a data mesh: the
    batch shards over ``data`` when its rows divide by the axis, else it is
    replicated (every rank computes all of it)."""
    n = int(mesh.shape.get("data", 1))
    return ("data",) if "data" in mesh.shape and global_batch % n == 0 else ()


def rank_microbatches(batch: Dict[str, torch.Tensor], mesh: DataMesh,
                      microbatches: int) -> List[Dict[str, torch.Tensor]]:
    """This rank's ``microbatches`` microbatches of the global ``batch``. The
    batch splits into contiguous microbatches as on one device. Where the
    global batch's rows divide by the mesh (``batch_axes_for``, the
    reference's rule on the global batch), rank r takes the contiguous r-th
    1/n of each microbatch, so its microbatch i is microbatch i n + r of one
    device's step with n times the microbatches; a microbatch whose rows do
    not divide then raises, as the port has no uneven split. Otherwise every
    rank takes all rows, as the reference replicates such a batch."""
    rows = batch["tokens"].shape[0]
    if rows % microbatches:
        raise ValueError(f"batch {rows} does not split into {microbatches} microbatches")
    m = rows // microbatches
    k, lo = m, 0
    if batch_axes_for(mesh, rows):
        if m % mesh.size:
            raise ValueError(f"the batch's {rows} rows shard over data={mesh.size}, but a "
                             f"microbatch's {m} rows do not: take microbatches so that "
                             f"each holds a multiple of {mesh.size} rows")
        k = m // mesh.size
        lo = mesh.rank * k
    return [{name: v[i * m + lo:i * m + lo + k] for name, v in batch.items()}
            for i in range(microbatches)]
