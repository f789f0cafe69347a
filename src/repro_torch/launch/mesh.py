"""The data-parallel mesh and the (pod, data, cp, model) grid on
``torch.distributed`` (the port of the reference's mesh axes,
``repro/launch/mesh.py``).

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

:class:`GridMesh` (``init_grid_mesh(data=, model=, ...)``) is the reference's
("data", "model") mesh for tensor parallelism: global rank ``d * model + m``
sits at data index d and model index m, as the reference lays devices out.
Each rank holds a :class:`DataMesh` over its data group (the ranks of its
model index), on which the ZeRO-1 code runs unchanged, and a
:class:`ModelRing` over its model group, which moves the rings' payloads
(``shift``) and sums the partials (``all_reduce_sum``). The transport rule is
the data mesh's: NCCL when each rank has its own card, gloo with host copies
when ranks share one (gloo's ``send``/``recv`` take no CUDA tensors).

With ``cp`` > 1 (``init_grid_mesh(data=, model=, cp=)``) the grid is the
reference's ("data", "cp", "model") mesh of context parallelism: global rank
``(d * cp + c) * model + m``. Its cp axis is another :class:`ModelRing`
(``GridMesh.cp``), over the ranks of one data and model index, which carries
the ring attention's KV chunks, the Mamba2 halo and state chain and the
sums over the sequence; the data group is then the ranks of one (cp, model)
index.

``GridMesh.ep`` is the expert ring of expert parallelism (MoE parallel
folding): the cp × model ranks of one data index as one flat ring, in (cp,
model) row-major order (the reference's axis tuple ``("cp", "model")``). It
is the model ring when the grid has no cp axis (the ep-only placement and
ep = tp), the cp ring when its model axis is 1, and a group of its own
otherwise. Its :meth:`ModelRing.all_to_all` and the hops of t steps
(:meth:`ModelRing.shift`) carry the expert tokens there and back.

With ``pod`` > 1 (``init_grid_mesh(pod=)``) the grid is the reference's
("pod", "data", "cp", "model") mesh of pipeline parallelism: global rank
``((p * data + d) * cp + c) * model + m``. Stage p's ranks are those of pod
index p; each holds a (data, cp, model) sub-grid of its own, whose data, cp,
model and expert groups are the ones above, one set per pod index, so
``resolve_context`` reads tp, cp, ep and data from it unchanged.
``GridMesh.pod`` is a :class:`ModelRing` with ``axis="pod"`` over the ranks
of one (data, cp, model) index, in stage order: it moves the activations
one stage on a tick (:meth:`ModelRing.shift` with ``wrap=False``: the last
stage sends nothing on, the first receives zeros) and sums the leaves every
stage holds (embedding, final norm, head).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.perf.roofline import CollectiveStats, link_bytes


class DataMesh:
    """One ``data`` axis over the ranks of ``group`` (every rank of the world
    when ``group`` is the default group). ``group=None`` is the mesh of one
    process, with no process group: its collectives are identities.

    The means are a SUM, then a division by the size (gloo has no AVG). The
    collectives add their wall time to ``seconds[kind]``; with
    ``timed`` set they first wait for the device, so that time is the
    collective's own. Each also adds its count, its result's bytes and its
    link bytes (``perf.roofline.link_bytes``) under the same kind:
    :meth:`collective_stats`."""

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
        self._stats = CollectiveStats.zeros(self.seconds)

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

    def collective_stats(self) -> CollectiveStats:
        """The collectives run so far, by kind: a copy."""
        return self._stats.copy()

    def _run(self, kind: str, op, out: torch.Tensor, inp: torch.Tensor,
             link: Optional[float] = None) -> None:
        """``op(out, inp)`` on the main group (``out is inp`` for an in-place
        collective), through host copies on the host transport, counted
        under ``kind`` with ``link`` bytes (default: the ring model of the
        kind on ``out``'s bytes)."""
        size = out.numel() * out.element_size()
        if link is None:
            link = link_bytes(kind.replace("_", "-"), size, self.size)
        self._stats.add(kind, size, link)
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

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` (contiguous) replaced in place by data rank ``src``'s: a
        ZeRO-3 layer's gather from its owner, timed and costed as an
        all-gather of ``t``."""
        if self.group is not None:
            g = dist.get_global_rank(self.group, src)
            self._run("all_gather",
                      lambda o, _: dist.broadcast(o, g, group=self.group), t, t)
        return t

    def reduce_mean_(self, t: torch.Tensor, dst: int) -> torch.Tensor:
        """``t`` (contiguous) replaced in place, on data rank ``dst``, by its
        mean over the ranks (elsewhere left undefined): a ZeRO-3 layer's
        grad to its owner, timed and costed as a reduce-scatter of ``t``
        (a block of 1/size of it per rank)."""
        if self.group is not None:
            g = dist.get_global_rank(self.group, dst)
            size = t.numel() * t.element_size()
            self._run("reduce_scatter",
                      lambda o, _: dist.reduce(o, g, group=self.group), t, t,
                      link=link_bytes("reduce-scatter", size / self.size, self.size))
        return t.div_(self.size)

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


def host_ranks(mesh) -> Tuple[int, int]:
    """(this process's index, the number of ranks) in ``mesh``'s
    ``host_group``: (0, 1) without a mesh or a host group."""
    group = getattr(mesh, "host_group", None) if mesh is not None else None
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def host_max(mesh, values: List[int]) -> List[int]:
    """The elementwise max of ``values`` (ints, as many on every rank) over the
    ranks of ``mesh``'s ``host_group``: one int64 all-reduce on that gloo
    group, so that it never interleaves with the step's collectives on the
    main group. Not counted in ``collective_stats`` (host traffic). The
    recovery driver's agreement on each step's decision
    (``ft.recovery.run_with_recovery``)."""
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return t.tolist()


def batch_axes_for(mesh, global_batch: int, pp: int = 1,
                   dp_over_model: bool = False) -> Tuple[str, ...]:
    """The reference's rule (``repro/launch/mesh.py:67``) on a data mesh or a
    grid: the mesh axes the global batch shards over, largest-first, each
    taken while the batch's rows still divide. The candidates are ``pod`` and
    ``data``, and ``model`` too under ``dp_over_model`` (the remap runs the
    model axis as more data parallelism); under ``pp`` > 1 ``pod`` carries
    the pipeline's stages and no batch. Without ``dp_over_model`` the model
    ranks hold the same rows and split the model. The port runs no pods as
    data replicas (``pp`` 1 on a pod axis is refused by
    ``train.executor.resolve_context``), so a pod axis carries stages only."""
    axes, div = [], 1
    wanted = ("pod", "data", "model") if dp_over_model else ("pod", "data")
    candidates = [a for a in wanted if a in mesh.shape]
    if pp > 1 and "pod" in candidates:
        candidates.remove("pod")
    for a in candidates:
        n = int(mesh.shape[a])
        if global_batch % (div * n) == 0:
            axes.append(a)
            div *= n
    return tuple(axes)


def data_mesh(mesh) -> Optional[DataMesh]:
    """The :class:`DataMesh` the ZeRO code runs on: a grid's data group (its
    data x model ranks when the grid was made with ``dp_over_model``), or
    ``mesh`` itself."""
    if isinstance(mesh, GridMesh):
        return mesh.flat if mesh.flat is not None else mesh.data
    return mesh


def model_size(mesh) -> int:
    """The size of ``mesh``'s model axis (1 without one)."""
    return int(mesh.shape.get("model", 1)) if mesh is not None else 1


def cp_size(mesh) -> int:
    """The size of ``mesh``'s cp axis (1 without one)."""
    return int(mesh.shape.get("cp", 1)) if mesh is not None else 1


def pod_size(mesh) -> int:
    """The size of ``mesh``'s pod axis, its pipeline stages (1 without one)."""
    return int(mesh.shape.get("pod", 1)) if mesh is not None else 1


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


class ModelRing:
    """The model, cp or expert axis of a grid: a ring over the global ranks
    ``ranks`` (in axis-index order) of ``group``, this process at index
    ``rank`` (the reference's ``axis_index``). It is the reference's
    ``RingCtx`` (``axis``: the mesh axis name, or the tuple of names of a
    folded ring; ``size``) with the transport attached: :meth:`shift` moves a
    tensor some hops (the reference's ``ppermute``), :meth:`all_to_all`
    exchanges blocks with every rank, :meth:`all_reduce_sum` sums over the
    ring (its ``psum``). ``group=None`` is the ring of one process, whose
    collectives are identities.

    Each collective adds its wall time to ``seconds[kind]`` ("tick" for a
    shift unless its caller names another kind, "a2a" for an all-to-all,
    "all_reduce"); with ``timed`` set it first waits for the device, so that
    time is the collective's own. Each also adds its count, its result's
    bytes and its link bytes (``perf.roofline.link_bytes``: a shift's are the
    bytes this rank sends) under the same kind: :meth:`collective_stats`."""

    def __init__(self, group=None, ranks: Tuple[int, ...] = (0,),
                 device: Union[str, torch.device] = "cpu", axis="model"):
        self.group = group
        self.axis = axis
        self.ranks = tuple(ranks)
        self.device = torch.device(device)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank()) if group is not None else 0
        self.backend = dist.get_backend(group) if group is not None else None
        self.transport = ("host" if self.backend == "gloo" and self.device.type == "cuda"
                          else "direct")
        self.timed = False
        self.seconds: Dict[str, float] = {"tick": 0.0, "a2a": 0.0, "all_reduce": 0.0}
        self._stats = CollectiveStats.zeros(self.seconds)

    def __repr__(self) -> str:
        return (f"ModelRing({self.axis}={self.size}, rank={self.rank}, backend={self.backend}, "
                f"transport={self.transport})")

    def _sync(self):
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def collective_stats(self) -> CollectiveStats:
        """The collectives run so far, by kind: a copy."""
        return self._stats.copy()

    def shift(self, t: torch.Tensor, step: int = 1, kind: str = "tick",
              wrap: bool = True) -> torch.Tensor:
        """``t`` sent ``step`` hops along the ring (negative: backwards)
        while the tensor of the rank ``step`` hops back is received: a new
        tensor of ``t``'s shape, dtype and device, its time under
        ``seconds[kind]``. One ``batch_isend_irecv`` pair (a NCCL ring
        deadlocks on separate isends and irecvs). With ``wrap=False`` the
        ring is a chain: a rank whose destination would wrap round sends
        nothing, and one whose source would receives zeros."""
        if self.group is None:
            return t.clone() if wrap else torch.zeros_like(t)
        dst_i, src_i = self.rank + step, self.rank - step
        send_ok = wrap or 0 <= dst_i < self.size
        recv_ok = wrap or 0 <= src_i < self.size
        size = t.numel() * t.element_size()
        self._stats.add(kind, size, link_bytes("collective-permute", size, self.size)
                        if send_ok else 0.0)
        self._sync()
        t0 = time.perf_counter()
        send = t.detach().contiguous()
        if self.transport == "host":
            send = send.cpu()
        recv = torch.empty_like(send) if recv_ok else None
        ops = []
        if send_ok:
            ops.append(dist.P2POp(dist.isend, send, self.ranks[dst_i % self.size], self.group))
        if recv_ok:
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks[src_i % self.size], self.group))
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        if recv is None:
            out = torch.zeros_like(t)
        else:
            out = recv.to(t.device) if self.transport == "host" else recv
        self._sync()
        self.seconds[kind] += time.perf_counter() - t0
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The all-to-all of ``t`` (size, ...): block j of dim 0 goes to ring
        rank j, and block j of the result is what ring rank j sent this rank
        (``all_to_all_single``): a new tensor of ``t``'s shape, dtype and
        device. It is its own transpose, so its backward is the same call on
        the cotangent."""
        if t.shape[0] != self.size:
            raise ValueError(f"an all-to-all over {self.size} ranks takes {self.size} "
                             f"blocks, got dim 0 of {tuple(t.shape)}")
        if self.group is None:
            return t.clone()
        size = t.numel() * t.element_size()
        self._stats.add("a2a", size, link_bytes("all-to-all", size, self.size))
        self._sync()
        t0 = time.perf_counter()
        send = t.detach().contiguous()
        if self.transport == "host":
            send = send.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        out = recv.to(t.device) if self.transport == "host" else recv
        self._sync()
        self.seconds["a2a"] += time.perf_counter() - t0
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ring: a new tensor (``t`` is left as it
        is, since autograd may have saved it)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the ring: a new tensor."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        out = t.detach().contiguous().clone()
        if self.group is None:
            return out
        size = out.numel() * out.element_size()
        self._stats.add("all_reduce", size, link_bytes("all-reduce", size, self.size))
        self._sync()
        t0 = time.perf_counter()
        if self.transport == "host":
            h = out.cpu()
            dist.all_reduce(h, op=op, group=self.group)
            out.copy_(h)
        else:
            dist.all_reduce(out, op=op, group=self.group)
        self._sync()
        self.seconds["all_reduce"] += time.perf_counter() - t0
        return out


class GridMesh:
    """The (pod, data, cp, model) grid of one rank: ``data`` (a :class:`DataMesh`
    over this rank's data group), ``model`` (a :class:`ModelRing` over its
    model group), ``cp`` (a :class:`ModelRing` over its cp group, ``None``
    without a cp axis), ``ep`` (the expert ring over its data index's cp ×
    model ranks, module docstring), ``pod`` (the pipeline's stage ring,
    ``None`` without a pod axis), ``shape`` ``{"pod": P, "data": D, "cp": C,
    "model": M}`` (the reference mesh's contract, which the layout rules and
    the checkpoint manifest read; "pod" only when P > 1 and "cp" only when
    C > 1), the global ``rank`` and ``size``, ``host_group``, a gloo group of
    every rank for host-side traffic, and ``save_group``, the gloo group of
    the ranks at cp index 0 (all of them without a cp axis), which hold every
    distinct shard of the state. ``flat`` is the :class:`DataMesh` over the
    data x model ranks of this rank's pod and cp index (global order: data
    index major) when the grid was made with ``dp_over_model``, else None."""

    def __init__(self, data: DataMesh, model: ModelRing, device, *, host_group=None,
                 cp: Optional[ModelRing] = None, save_group=None,
                 ep: Optional[ModelRing] = None, pod: Optional[ModelRing] = None,
                 flat: Optional[DataMesh] = None):
        self.data, self.model, self.cp, self.pod = data, model, cp, pod
        self.flat = flat
        self.ep = ep if ep is not None else (cp if cp is not None and model.size == 1
                                             else model)
        self.device = torch.device(device)
        self.host_group = host_group
        self.save_group = save_group if save_group is not None else host_group
        self.size = (data.size * model.size * (cp.size if cp is not None else 1)
                     * (pod.size if pod is not None else 1))
        self.rank = dist.get_rank() if dist.is_initialized() else 0

    @property
    def shape(self) -> Dict[str, int]:
        out = {"pod": self.pod.size} if self.pod is not None else {}
        out["data"] = self.data.size
        if self.cp is not None:
            out["cp"] = self.cp.size
        out["model"] = self.model.size
        return out

    def __repr__(self) -> str:
        pod = f"pod={self.pod.size}, " if self.pod is not None else ""
        cp = f"cp={self.cp.size}, " if self.cp is not None else ""
        ring = next((r for r in (self.model, self.cp, self.pod)
                     if r is not None and r.group is not None), self.model)
        return (f"GridMesh({pod}data={self.data.size}, {cp}model={self.model.size}, "
                f"rank={self.rank}, backend={ring.backend}, transport={ring.transport}, "
                f"device={self.device})")

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
        if dist.is_initialized():
            dist.destroy_process_group()
        self.host_group = self.save_group = self.data.group = self.data.host_group = None
        self.model.group = self.ep.group = None
        if self.flat is not None:
            self.flat.group = self.flat.host_group = None
        for ring in (self.cp, self.pod):
            if ring is not None:
                ring.group = None


# the dry run's fake c10d backend, for the CPU and meta devices
FAKE_BACKEND = "cpu:fake,meta:fake"


def init_grid_mesh(data: int, model: int, device: Optional[Union[str, torch.device]] = None,
                   *, cp: int = 1, pod: int = 1, backend: Optional[str] = None,
                   init_method: str = "env://", rank: Optional[int] = None,
                   dp_over_model: bool = False) -> GridMesh:
    """Join the process group of ``pod * data * cp * model`` ranks and return
    this rank's :class:`GridMesh`. ``device`` and ``backend`` as in
    :func:`init_data_mesh` (gloo on CUDA: the host transport, the only way to
    put two ranks on one card). Every rank creates every data, cp and model
    group (one set per pod index), in the same order, as ``dist.new_group``
    requires, then the expert rings where both cp and model are 2 or more,
    then the pod rings, and last, with ``dp_over_model``, the flat data groups
    of the data x model ranks (``GridMesh.flat``); an axis of size 1 gets no
    group. ``backend="fake"`` joins a fake c10d group of the grid's size as
    global rank ``rank`` (the dry run, ``launch/dryrun.py``; every group
    fake, for CPU and meta tensors, the card's runtime untouched): its
    collectives move nothing."""
    device = resolve_device(device)
    fake = backend == "fake"
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0 if fake else torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL moves CUDA tensors; a CPU mesh takes gloo")
    if device.type == "cuda" and not fake:
        torch.cuda.set_device(device)
    world = pod * data * cp * model
    kwargs = {} if rank is None else {"rank": rank, "world_size": world}
    if fake:
        # the dry run's group: collectives on meta tensors, no transport
        from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: PLC0415
        kwargs = {"store": FakeStore(), "rank": rank or 0, "world_size": world}
        backend = FAKE_BACKEND
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend, **kwargs)
    host = FAKE_BACKEND if fake else "gloo"
    if dist.get_world_size() != world:
        raise ValueError(f"a ({pod}, {data}, {cp}, {model}) grid needs {world} ranks, the "
                         f"group has {dist.get_world_size()}")
    me = dist.get_rank()

    def at(p, d, c, m):
        return ((p * data + d) * cp + c) * model + m
    p_idx, rest = divmod(me, data * cp * model)
    d_idx, rest = divmod(rest, cp * model)
    c_idx, m_idx = divmod(rest, model)
    host_group = dist.new_group(backend=host)
    save_group = (dist.new_group([at(p, d, 0, m) for p in range(pod) for d in range(data)
                                  for m in range(model)], backend=host) if cp > 1 else None)
    data_mesh_ = DataMesh(device=device)
    for p in range(pod):                        # one data group per (pod, cp, model) index
        for c in range(cp):
            for m in range(model):
                ranks = [at(p, d, c, m) for d in range(data)]
                if data > 1:
                    g, hg = dist.new_group(ranks), dist.new_group(ranks, backend=host)
                    if (p, c, m) == (p_idx, c_idx, m_idx):
                        data_mesh_ = DataMesh(g, device, host_group=hg)
    cp_ring = None
    for p in range(pod):                        # one cp ring per (pod, data, model) index
        for d in range(data):
            for m in range(model):
                ranks = [at(p, d, c, m) for c in range(cp)]
                if cp > 1:
                    g = dist.new_group(ranks)
                    if (p, d, m) == (p_idx, d_idx, m_idx):
                        cp_ring = ModelRing(g, ranks, device, axis="cp")
    ring = ModelRing(device=device)
    for p in range(pod):                        # one model ring per (pod, data, cp) index
        for d in range(data):
            for c in range(cp):
                ranks = [at(p, d, c, m) for m in range(model)]
                if model > 1:
                    g = dist.new_group(ranks)
                    if (p, d, c) == (p_idx, d_idx, c_idx):
                        ring = ModelRing(g, ranks, device)
    fold = None
    for p in range(pod):                        # one expert ring per (pod, data) index
        for d in range(data):
            ranks = [at(p, d, c, m) for c in range(cp) for m in range(model)]
            if cp > 1 and model > 1:
                g = dist.new_group(ranks)
                if (p, d) == (p_idx, d_idx):
                    fold = ModelRing(g, ranks, device, axis=("cp", "model"))
    pod_ring = None
    for d in range(data):                       # one pod ring per (data, cp, model) index
        for c in range(cp):
            for m in range(model):
                ranks = [at(p, d, c, m) for p in range(pod)]
                if pod > 1:
                    g = dist.new_group(ranks)
                    if (d, c, m) == (d_idx, c_idx, m_idx):
                        pod_ring = ModelRing(g, ranks, device, axis="pod")
    flat = None
    for p in range(pod):                        # one flat data group per (pod, cp) index
        for c in range(cp):
            ranks = [at(p, d, c, m) for d in range(data) for m in range(model)]
            if dp_over_model and data * model > 1:
                g, hg = dist.new_group(ranks), dist.new_group(ranks, backend=host)
                if (p, c) == (p_idx, c_idx):
                    flat = DataMesh(g, device, host_group=hg)
    if dp_over_model and flat is None:
        flat = DataMesh(device=device)
    return GridMesh(data_mesh_, ring, device, host_group=host_group, cp=cp_ring,
                    save_group=save_group, ep=fold, pod=pod_ring, flat=flat)
