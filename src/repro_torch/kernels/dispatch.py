"""Kernel dispatch — pick an implementation per call site (attention, MoE
expert-GEMM and SSD parts of ``repro/kernels/dispatch.py``).

Model code calls :func:`dispatch_attention` (via ``repro_torch.models.layers``)
with ``ParallelPlan.attn_impl``, resolved by :func:`select_impl`, and
:func:`dispatch_expert_gemm` (via ``repro_torch.models.moe``) with
``ParallelPlan.moe_gemm_impl``, resolved by :func:`select_gemm_impl`, and
:func:`dispatch_ssd_scan` (via ``repro_torch.models.ssm``) with
``ParallelPlan.ssm_impl``, resolved by :func:`select_ssd_impl`, under the same
three rules:

- ``"plain"`` — always the plain PyTorch twin (``attention_direct``, or
  ``attention_blockwise`` for long KV).
- ``"cuda"``  — always the hand-written CUDA kernels; a CPU tensor raises.
- ``"auto"``  — the kernels on a CUDA tensor, the plain twin on a CPU tensor.

The kernel paths are differentiable: ``flash_attention`` is the autograd
Function over the forward kernel (B1) and the two backward kernels (B2, B3),
``expert_gemm`` the one over the grouped GEMM (B4: forward and dx in rows
mode, dw in contract mode), ``ssd_chunk_scan`` the one over the SSD forward
(B5) and backward (B6), and the plain twins differentiate through autograd.
The ring
attention of context parallelism (``train/executor.py``) calls B1 and B2/B3
one tile at a time: :func:`dispatch_attention_lse` returns a tile's (o, lse)
for the merge, and :func:`dispatch_attention_chunk_bwd` a tile's (dq, dk, dv)
against the statistics merged over every tile of the row. :func:`select_cp_impl`
resolves ``ParallelPlan.cp_impl``, :func:`select_tp_impl`
``ParallelPlan.tp_impl``, and :func:`dispatch_tp_matmul` is the one tile GEMM
of the tensor-parallel rings (``train/tensor_parallel.py``).
:func:`dispatch_ep_a2a` is the expert-parallel exchange around the expert
GEMMs (``ParallelPlan.ep_impl``, resolved by :func:`select_ep_impl`): the
blocking all-to-all or the overlap ring of ticks.

On CUDA the kernel takes the head dims it has bodies for
(``flash_attention.HEAD_DIMS``) and the call raises for any other; it never
falls back to the twin.

In the reference, gemma2's local/global alternation makes the window a traced
scan value, so the reference falls back to XLA there. The port runs its layers
as a Python loop, so the window is a per-layer ``int`` and the kernel serves
gemma2 too: the dispatch choice differs, the numbers do not.

Layout contract: model code is batch-major (B, S, H, hd), the kernel
head-major. The dispatcher owns the transposes (views: the kernel reads and
writes through strides) and, for the plain twin, the KV padding to the block
boundary — never a silent fall-back to the quadratic path on unaligned lengths.

Fault seams: each dispatcher's output passes a named fault point
(``kernel.attention``, ``kernel.expert_gemm``, ``kernel.ssd``; ``_tainted``,
``repro_torch.ft.inject``). Unarmed it costs one attribute read, launches
nothing and copies nothing; armed, it corrupts what the chosen body returned
and never changes which body runs.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.config import ATTN_IMPLS, CP_IMPLS, EP_IMPLS, Family, check_tp_impl
from repro_torch.ft import inject as _inject
from repro_torch.models import layers as _layers
from repro_torch.models.ssm import ssd_scan
from . import build
from . import flash_attention as _fa
from .flash_attention import HEAD_DIMS, flash_attention
from .grouped_gemm import expert_gemm
from .ssd_scan import ssd_chunk_scan


def _tainted(point: str):
    """Route a dispatcher's primary output through the fault point ``point``
    (a tuple return taints its first element): the identity while nothing is
    armed, as the reference's seam is outside an armed trace."""
    if point not in _inject.FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if not _inject.CONTROLLER._specs:
                return out
            if isinstance(out, tuple):
                return (_inject.taint(point, out[0]),) + out[1:]
            return _inject.taint(point, out)
        return wrapper
    return deco


def _resolve(impl: str, knob: str, device) -> str:
    """The three rules of the module docstring -> "plain" | "cuda"."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"{knob} must be one of {ATTN_IMPLS}, got {impl!r}")
    on_cuda = torch.device(device).type == "cuda" or build.fake_card_active()
    if impl == "plain" or (impl == "auto" and not on_cuda):
        return "plain"
    if not on_cuda:
        raise ValueError(f"{knob}='cuda' forces the CUDA kernel; the tensor is "
                         f"on {device}")
    return "cuda"


def select_impl(impl: str, *, head_dim: int, device) -> str:
    """Resolve the attention impl for a call on ``device`` -> "plain" | "cuda"."""
    if _resolve(impl, "attn_impl", device) == "plain":
        return "plain"
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attn_impl={impl!r}: the CUDA kernel takes head dims "
                         f"{HEAD_DIMS}, not {head_dim}; use attn_impl='plain'")
    return "cuda"


@_tainted("kernel.attention")
def dispatch_attention(q, k, v, *, impl: str = "auto", causal: bool = True,
                       window: int = 0, softcap: float = 0.0, q_offset: int = 0,
                       block_size: int = 1024, scale: Optional[float] = None):
    """q: (B, S, Hq, hd), k/v: (B, T, Hkv, hd) -> (B, S, Hq, hd)."""
    choice = select_impl(impl, head_dim=q.shape[-1], device=q.device)
    if choice == "cuda":
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=int(window), softcap=softcap, scale=scale,
            q_offset=int(q_offset))
        return out.transpose(1, 2)

    t = k.shape[1]
    if t <= 2 * block_size:
        return _layers.attention_direct(
            q, k, v, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, scale=scale)
    if t % block_size:
        # pad KV to the block boundary and mask the tail — never drop to the
        # O(S·T) direct path just because the context length is unaligned
        t_pad = -(-t // block_size) * block_size
        return _layers.attention_blockwise(
            q, _layers.pad_seq(k, 1, t_pad), _layers.pad_seq(v, 1, t_pad), causal=causal,
            window=window, softcap=softcap, q_offset=q_offset,
            block_size=block_size, scale=scale, kv_len=t)
    return _layers.attention_blockwise(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_offset=q_offset, block_size=block_size, scale=scale)


def dispatch_attention_lse(q, k, v, *, impl: str = "auto", causal: bool = True,
                           window: int = 0, softcap: float = 0.0, q_offset: int = 0,
                           scale: Optional[float] = None):
    """One tile of chunked attention with its softmax statistic, batch-major:
    q (B, S, Hq, hd), k/v (B, T, Hkv, hd) -> (o (B, S, Hq, hd), lse (B, S, Hq)
    fp32). The kernel (B1's wrapper ``flash_attention_lse``) on "cuda", its
    plain version on "plain"; never a fall-back from one to the other. A fully
    masked row gives o = 0 and lse ~ ``NEG_INF``, so it drops out of the
    merge."""
    kw = dict(causal=causal, window=int(window), softcap=softcap, scale=scale,
              q_offset=int(q_offset))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if select_impl(impl, head_dim=q.shape[-1], device=q.device) == "cuda":
        o, lse = _fa.flash_attention_lse(qh, kh, vh, **kw)
    else:
        o, lse = _fa.flash_attention_lse_plain(qh, kh, vh, **kw)
    return o.transpose(1, 2), lse.transpose(1, 2)


def dispatch_attention_chunk_bwd(q, k, v, do, lse, delta, *, impl: str = "auto",
                                 causal: bool = True, softcap: float = 0.0,
                                 q_offset: int = 0, scale: Optional[float] = None):
    """One KV tile's (dq, dk, dv) against the softmax statistics ``lse`` and
    ``delta`` (B, S, Hq), which may come from more keys than the tile holds,
    batch-major: q/do (B, S, Hq, hd), k/v (B, T, Hkv, hd). B2/B3 (the wrapper
    ``flash_attention_bwd``) on "cuda", their plain version on "plain". ``do``
    is taken in q's dtype and the grads come back in it, as the reference's
    kernel path casts them."""
    kw = dict(causal=causal, window=0, softcap=softcap, scale=scale, q_offset=int(q_offset))
    hm = lambda x: x.transpose(1, 2)          # noqa: E731 (batch- <-> head-major)
    args = (hm(q), hm(k), hm(v), hm(do.to(q.dtype)), hm(lse), hm(delta))
    if select_impl(impl, head_dim=q.shape[-1], device=q.device) == "cuda":
        dq, dk, dv = _fa.flash_attention_bwd(*args, **kw)
    else:
        dq, dk, dv = _fa.flash_attention_bwd_plain(*args, **kw)
    return hm(dq), hm(dk), hm(dv)


# ---------------------------------------------------------------------------
# MoE expert GEMM


def select_gemm_impl(impl: str, *, device) -> str:
    """Resolve the expert-GEMM impl for a call on ``device`` -> "plain" | "cuda".
    The kernel masks every ragged dim itself, so "cuda" takes any shape."""
    return _resolve(impl, "moe_gemm_impl", device)


@_tainted("kernel.expert_gemm")
def dispatch_expert_gemm(x, w, group_sizes=None, *, impl: str = "auto"):
    """x: (E, C, d) x w: (E, d, f) -> (E, C, f); ``group_sizes`` (E,) marks the
    real rows per expert (padding rows are masked out of outputs and grads).
    The plain twin is the reference's masked einsum in the input dtype."""
    if select_gemm_impl(impl, device=x.device) == "cuda":
        return expert_gemm(x, w, group_sizes)
    if group_sizes is not None:
        rows = torch.arange(x.shape[1], device=x.device)[None, :, None]
        x = torch.where(rows < group_sizes.detach()[:, None, None], x, 0)
    return torch.einsum("ecd,edf->ecf", x, w)


# ---------------------------------------------------------------------------
# Mamba2 SSD chunk scan


def select_ssd_impl(impl: str, *, device, has_initial_state: bool = False) -> str:
    """Resolve the SSD impl for a call on ``device`` -> "plain" | "cuda".

    The kernels start from a zero state, as the Pallas kernels do. Where the
    reference silently takes its XLA twin for a caller's initial state, the
    port raises on a CUDA tensor under "auto" and "cuda". No path passes one:
    context parallelism scans each rank's chunk from a zero state and adds the
    entering state's share in closed form (``train/executor.py``), as the
    reference does. The plain twin honours one."""
    choice = _resolve(impl, "ssm_impl", device)
    if choice == "cuda" and has_initial_state:
        raise NotImplementedError(
            f"ssm_impl={impl!r}: the SSD kernels start from a zero state; use "
            f"ssm_impl='plain' for an initial state")
    return choice


@_tainted("kernel.ssd")
def dispatch_ssd_scan(x, dt, A, B, C, *, chunk: int, impl: str = "auto",
                      initial_state=None):
    """Model layout: x (B, L, H, P), dt (B, L, H), A (H,), B/C (B, L, G, N).
    Returns (y (B, L, H, P) fp32, final_state (B, H, P, N) fp32).

    ``chunk = min(chunk, L)``. An unaligned length is padded to the chunk boundary
    with dt = 0 steps (decay exp(0) = 1, zero input: the state rides through
    unchanged) and y is cut back to L, never collapsed into one whole-sequence
    chunk with an O(L^2) decay matrix. The kernel does that padding as a masked
    load of the ragged last chunk; the plain twin pads. The kernel reads the
    head-major views through strides.
    """
    l = x.shape[1]
    chunk = min(int(chunk), l)
    choice = select_ssd_impl(impl, device=x.device,
                             has_initial_state=initial_state is not None)
    if choice == "cuda":
        y, state = ssd_chunk_scan(x.transpose(1, 2), dt.transpose(1, 2), A,
                                  B.transpose(1, 2), C.transpose(1, 2), chunk=chunk)
        return y.transpose(1, 2), state
    l_pad = -(-l // chunk) * chunk
    y, state = ssd_scan(_layers.pad_seq(x, 1, l_pad), _layers.pad_seq(dt, 1, l_pad), A,
                        _layers.pad_seq(B, 1, l_pad), _layers.pad_seq(C, 1, l_pad), chunk=chunk,
                        initial_state=initial_state)
    return y[:, :l], state


# ---------------------------------------------------------------------------
# context- and tensor-parallel rings


def select_cp_impl(impl: str, *, family: str = Family.DENSE, window: int = 0,
                   local_global_alternating: bool = False) -> str:
    """Resolve ``ParallelPlan.cp_impl`` -> "ring" | "gather" (the reference's
    rule). The SSM family always runs "ring" (the entering-state chain; there
    is no KV to gather). "ring" needs full causal attention, since its tiles'
    masks are fixed by their place in the zigzag (no window, no local/global
    alternation), and raises otherwise; "auto" takes "ring" where it can and
    "gather" elsewhere."""
    if impl not in CP_IMPLS:
        raise ValueError(f"cp_impl must be one of {CP_IMPLS}, got {impl!r}")
    if family == Family.SSM:
        return "ring"
    ring_ok = not window and not local_global_alternating
    if impl == "ring" and not ring_ok:
        raise ValueError("cp_impl='ring' needs full causal attention (no sliding window / "
                         "local-global alternation); use cp_impl='gather'")
    if impl == "auto":
        return "ring" if ring_ok else "gather"
    return impl


def select_tp_impl(impl: str) -> str:
    """Resolve ``ParallelPlan.tp_impl`` -> "overlap".

    ``"overlap"`` is the rings of ``repro_torch.train.tensor_parallel``
    (collective matmuls, sequence-sharded activations). ``"auto"`` resolves to
    them on every device: the reference picks its GSPMD twin off the TPU, an
    XLA partitioner the port does not have (ROADMAP queue C). ``"gspmd"``
    raises ``NotImplementedError`` (``core.config.check_tp_impl``)."""
    check_tp_impl(impl)
    return "overlap"


def dispatch_tp_matmul(x, w):
    """One ring tick's partial GEMM: ``x`` (..., k) against the weight shard
    ``w`` (k, f). In the reference it is an XLA dot, not a Pallas kernel, so
    here it is ``torch.matmul``; every tile GEMM of the rings goes through it,
    the single place a fused tile GEMM would slot in."""
    return torch.matmul(x, w)


# ---------------------------------------------------------------------------
# the expert-parallel dispatch / combine exchange (survey §4.1.5)


def select_ep_impl(impl: str) -> str:
    """Resolve ``ParallelPlan.ep_impl`` -> "blocking" | "overlap" (the
    reference's rule). ``"blocking"`` runs one all-to-all before the expert
    GEMMs and one after them, the whole exchange on the critical path;
    ``"overlap"`` splits each into ring ticks with the GEMMs of the chunk the
    rank already holds between them. ``"auto"`` is ``"overlap"`` everywhere:
    the two compute the same function."""
    if impl not in EP_IMPLS:
        raise ValueError(f"ep_impl must be one of {EP_IMPLS}, got {impl!r}")
    return "overlap" if impl == "auto" else impl


class _AllToAll(torch.autograd.Function):
    """``ring.all_to_all``, differentiable: the exchange is its own transpose,
    so the backward sends every cotangent block back to where its block came
    from with the same call."""

    @staticmethod
    def forward(ctx, ring, x):
        ctx.ring = ring
        return ring.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ring.all_to_all(g.contiguous())


def _ep_a2a_blocking(fn, ring, w, h):
    """The exposed exchange: dispatch all-to-all, ``fn`` on the rank's
    experts over every peer's rows, combine all-to-all. Plain autograd runs
    its backward (the reverse exchanges), so it is the gradient oracle of the
    overlap ring."""
    n = ring.size
    e, c, d = h.shape
    e_loc = e // n
    # fault seam: the dispatched payload as it lands
    hx = _inject.taint("ep.a2a.tick", _AllToAll.apply(ring, h.reshape(n, e_loc, c, d)))
    # hx[j]: peer j's rows for this rank's experts, blocked per source peer
    y = fn(w, hx.transpose(0, 1).reshape(e_loc, n * c, d))
    yr = y.reshape(e_loc, n, c, -1).transpose(0, 1).contiguous()
    return _AllToAll.apply(ring, yr).reshape(e, c, -1)


def _ep_overlap_ticks(fn, ring, w, h):
    """The overlap ring's forward: at tick t the rank sends the chunk meant
    for rank r + t, receives from rank r - t the chunk that rank dispatched
    to this rank's experts, runs ``fn`` on it and ships the result back t
    hops; tick 0 is its own chunk, with no exchange."""
    n, r = ring.size, ring.rank
    e, c, d = h.shape
    hr = h.reshape(n, e // n, c, d)
    y0 = fn(w, hr[r])
    out = y0.new_empty((n,) + tuple(y0.shape))
    out[r] = y0
    for t in range(1, n):
        # fault seam: the dispatched chunk as it lands from rank r - t
        recv = _inject.taint("ep.a2a.tick", ring.shift(hr[(r + t) % n], t, kind="a2a"))
        out[(r + t) % n] = ring.shift(fn(w, recv), -t, kind="a2a")
    return out.reshape(e, c, -1)


class _EPOverlap(torch.autograd.Function):
    """The overlap ring with the reference's backward (``_ep_overlap_bwd``):
    it saves only its inputs and re-runs the dispatch ring, sending each
    tick's output cotangent along with the chunk, takes the grads of ``fn``
    on that chunk (``torch.autograd.grad``) and sends the chunk's input grad
    back along the combine direction. The weights' grads add up over the
    ticks. Every rank runs every hop, in the same order, in the forward, a
    remat recompute and the backward."""

    @staticmethod
    def forward(ctx, fn, ring, keys, h, *ws):
        ctx.fn, ctx.ring, ctx.keys = fn, ring, keys
        ctx.save_for_backward(h, *ws)
        return _ep_overlap_ticks(fn, ring, dict(zip(keys, ws)), h)

    @staticmethod
    def backward(ctx, dout):
        fn, ring, keys = ctx.fn, ctx.ring, ctx.keys
        h, *ws = ctx.saved_tensors
        n, r = ring.size, ring.rank
        e, c, d = h.shape
        hr = h.reshape(n, e // n, c, d)
        dr = dout.reshape(n, e // n, c, -1)
        dh = torch.empty_like(hr)
        dws = [None] * len(ws)

        def vjp(chunk, dy):
            with torch.enable_grad():
                x = chunk.detach().requires_grad_()
                wl = [w.detach().requires_grad_() for w in ws]
                y = fn(dict(zip(keys, wl)), x)
                grads = torch.autograd.grad(y, (x, *wl), dy)
            for i, g in enumerate(grads[1:]):
                dws[i] = g if dws[i] is None else dws[i] + g
            return grads[0]

        dh[r] = vjp(hr[r], dr[r])
        for t in range(1, n):
            j = (r + t) % n
            recv = ring.shift(hr[j], t, kind="a2a")
            dy = ring.shift(dr[j].contiguous(), t, kind="a2a")
            dh[j] = ring.shift(vjp(recv, dy), -t, kind="a2a")
        return (None, None, None, dh.reshape(e, c, d), *dws)


def dispatch_ep_a2a(fn, w, h, *, ring, impl: str = "auto"):
    """The EP dispatch -> expert compute -> combine exchange, one seam.

    ``h``: (E, C, d), this rank's dispatch buffers for all E experts (E
    divisible by the ring's size; ring rank j owns the E / size experts of
    block j). ``fn(w, chunk)`` runs this rank's experts (``w``, a dict of
    tensors, e.g. ``models.moe.ep_chunk_ffn``) on a (E / size, C', d) row
    block and must be row-wise (shape-polymorphic in C'), so that a chunk at
    a time equals the whole buffer. ``ring`` (``launch.mesh.ModelRing``, the
    grid's expert ring; None: one rank) carries the exchange, as
    ``select_ep_impl(impl)`` says. Returns the combined (E, C, f) buffers in
    dispatch order."""
    choice = select_ep_impl(impl)
    if ring is None or ring.size == 1:
        return fn(w, h)
    if h.shape[0] % ring.size:
        raise ValueError(f"the global expert dim {h.shape[0]} must divide over the ep "
                         f"ring's {ring.size} ranks")
    if choice == "blocking":
        return _ep_a2a_blocking(fn, ring, w, h)
    keys = tuple(sorted(w))
    return _EPOverlap.apply(fn, ring, keys, h, *(w[k] for k in keys))
