"""Per-expert batched GEMM: the hand-written Hopper kernel and its plain twin.

Counterpart of ``repro/kernels/grouped_gemm.py``: the masked per-expert product
``_grouped_gemm`` (both mask modes) is :func:`grouped_gemm`, the custom VJP
``_gemm`` is :class:`ExpertGemm`, and :func:`expert_gemm` is the entry. The
kernel is ``csrc/grouped_gemm.cu``, CUDA C++ for ``sm_90a`` bound with ctypes;
its source note says how it maps the TPU kernel onto Hopper and what bounds it.

``(E, M, K) x (E, K, N) -> (E, M, N)``, accumulated in fp32 and written in the
input dtype, masked by ``group_sizes`` (E,) int32 in one of two modes:

- ``"rows"`` (forward, and dx = g . w^T): rows m >= gs[e] of the output are 0;
- ``"contract"`` (dw = x^T . g): contraction indices k >= gs[e] contribute
  nothing (padding rows must not reach the weight gradient).

:func:`grouped_gemm` is the wrapper: a CUDA tensor launches the kernel (or the
call raises), a CPU tensor takes :func:`grouped_gemm_plain`, the plain PyTorch
version of the same function. There is no fall-back from one to the other. The
kernel reads both operands through strides, so the backward passes w^T and x^T
as views (the reference materialises them), and it reads the group sizes from
device memory: nothing on the path waits for them on the host. Tiles are the
kernel's own choice, so the reference's ``block_c``/``block_f``/``block_d``/
``interpret`` arguments have no counterpart.

On the card the body is a static rule (:func:`gemm_body`): bf16 with N a
multiple of 8 and both operands within TMA's 16-byte rule (every MoE path's
shape: prefill, decode and training) runs the Hopper body; other bf16 calls
(strides off the 16-byte rule) the first-version ``mma.sync`` body; fp32 the
FMA body. A failed launch raises; no call moves to another body.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .ref import expert_gemm_ref

MASK_MODES = ("rows", "contract")
_DTYPES = (torch.float32, torch.bfloat16)
_BODIES = {"f32": 0, "mma": 1, "sm90": 2}        # csrc/grouped_gemm.cu's body codes


def grouped_gemm_plain(x, w, gs=None, *, mask: str = "rows"):
    """Plain PyTorch version of the kernel: the masked operands through one fp32
    einsum, cast to x's dtype. ``"rows"`` is ``expert_gemm_ref`` (x's rows >= gs
    zeroed, so those output rows are 0); ``"contract"`` zeroes contraction
    indices >= gs in both operands, as the kernel reads them."""
    if mask == "rows" or gs is None:
        return expert_gemm_ref(x, w, gs)
    ks = torch.arange(x.shape[2], device=x.device)
    x = torch.where(ks[None, None, :] < gs[:, None, None], x, 0)
    w = torch.where(ks[None, :, None] < gs[:, None, None], w, 0)
    return expert_gemm_ref(x, w)


@functools.cache
def _kernel():
    fn = build.load("grouped_gemm").grouped_gemm
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr] * 4 + [i64] * 6 + [i32] * 10 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w, gs, mask):
    if mask not in MASK_MODES:
        raise ValueError(f"mask must be one of {MASK_MODES}, got {mask!r}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"want x (E, M, K) and w (E, K, N), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype:
        raise ValueError(f"dtypes differ: {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"devices differ: {x.device}, {w.device}")
    if gs is not None:
        if gs.shape != (x.shape[0],) or gs.dtype != torch.int32 or gs.device != x.device:
            raise ValueError(f"group sizes must be int32 ({x.shape[0]},) on {x.device}, "
                             f"got {gs.dtype} {tuple(gs.shape)} on {gs.device}")


def _layout(t, k_dim: int, row_dim: int):
    """(kmaj, vec) for one operand: whether its k direction is the one the
    kernel walks contiguously (else its row direction is), and whether it meets
    the 16-byte rule (bf16, unit stride there, the other strides multiples of 8
    elements, a 16-byte aligned base): the mma.sync body then copies 16 bytes at
    a time, and the Hopper body's TMA maps take it (K-major where kmaj, else
    MN-major)."""
    st = t.stride()
    kmaj = not (st[row_dim] == 1 and st[k_dim] != 1)
    unit, other = (k_dim, row_dim) if kmaj else (row_dim, k_dim)
    vec = (t.dtype == torch.bfloat16 and st[unit] == 1 and t.data_ptr() % 16 == 0
           and all(t.shape[d] == 1 or st[d] % 8 == 0 for d in (0, other)))
    return int(kmaj), int(vec)


def _strides(t):
    """t's strides, those of size-1 dims (never stepped) replaced by the
    tensor's extent in elements rounded up to a multiple of 8, which TMA's
    encoder accepts."""
    extent = 1 + sum(s * (n - 1) for s, n in zip(t.stride(), t.shape))
    span = 8 * -(-extent // 8)
    return [s if n > 1 else span for s, n in zip(t.stride(), t.shape)]


def gemm_body(x, w) -> str:
    """The body for x (E, M, K) x w (E, K, N) on the card: "sm90" (the Hopper
    body) for bf16 with both operands within the 16-byte rule (:func:`_layout`)
    and N a multiple of 8 (the output's rows, which TMA stores, 16-byte aligned),
    at any row count (it measured faster than the first version from one row
    per expert up, csrc/grouped_gemm.cu's note); "mma" (the first version) for
    other bf16 calls; "f32" for fp32."""
    if x.dtype == torch.float32:
        return "f32"
    if w.shape[2] % 8 == 0 and _layout(x, 2, 1)[1] and _layout(w, 1, 2)[1]:
        return "sm90"
    return "mma"


def grouped_gemm(x, w, gs=None, *, mask: str = "rows"):
    """x (E, M, K) x w (E, K, N) -> (E, M, N) in x's dtype, masked by ``gs``
    (None: every row / every contraction index) in ``mask`` mode.

    CUDA tensors launch the kernel's body that :func:`gemm_body` names (bf16 or
    fp32; any other dtype raises); ``grouped_gemm.rows_launches`` /
    ``.contract_launches`` count the launches by mask mode, ``.sm90_launches``,
    ``.mma_launches`` and ``.f32_launches`` by body. CPU tensors take
    :func:`grouped_gemm_plain`.
    """
    _check(x, w, gs, mask)
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, gs, mask=mask)
    if x.device.type != "cuda":
        raise ValueError(f"the grouped GEMM runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {x.dtype}")
    e, m, k = x.shape
    n = w.shape[2]
    if max(e, m, n, k) >= 2 ** 31:
        raise ValueError(f"dims {(e, m, k, n)} exceed the kernel's int32 indices")
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if gs is not None:
        gs = gs.contiguous()
    _launch(gemm_body(x, w), x, w, out, gs, mask)
    return out


def _launch(body, x, w, out, gs, mask):
    """Launch ``body`` on checked inputs and an allocated output; counts the
    launch by mask mode and by body."""
    e, m, k = x.shape
    n = w.shape[2]
    a_kmaj, a_vec = _layout(x, 2, 1)
    b_kmaj, b_vec = _layout(w, 1, 2)
    err = _kernel()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), 0 if gs is None else gs.data_ptr(),
        *_strides(x), *_strides(w), e, m, n, k, int(mask == "contract"),
        a_kmaj, a_vec, b_kmaj, b_vec, _BODIES[body],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"grouped_gemm ({mask}, {body} body) launch failed: "
                           f"{build.launch_error(err)}")
    if mask == "rows":
        grouped_gemm.rows_launches += 1
    else:
        grouped_gemm.contract_launches += 1
    if body == "sm90":
        grouped_gemm.sm90_launches += 1
    elif body == "mma":
        grouped_gemm.mma_launches += 1
    else:
        grouped_gemm.f32_launches += 1


grouped_gemm.rows_launches = 0
grouped_gemm.contract_launches = 0
grouped_gemm.sm90_launches = 0             # the Hopper body
grouped_gemm.mma_launches = 0              # the first-version bf16 body
grouped_gemm.f32_launches = 0


class ExpertGemm(torch.autograd.Function):
    """The reference's ``_gemm`` custom VJP. The forward runs the rows mode; the
    backward runs dx = g . w^T in rows mode (padding rows never reached the
    output, so their cotangent is zero) and dw = x^T . g in contract mode (only
    real rows reach the weight gradient), both with transposed views."""

    @staticmethod
    def forward(ctx, x, w, gs):
        ctx.save_for_backward(x, w, gs)
        return grouped_gemm(x, w, gs, mask="rows")

    @staticmethod
    def backward(ctx, g):
        # g, x and w share one dtype (the wrapper checks x's against w's), so dx
        # and dw come back in x's and w's
        x, w, gs = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_gemm(g, w.transpose(1, 2), gs, mask="rows")
        if ctx.needs_input_grad[1]:
            dw = grouped_gemm(x.transpose(1, 2), g, gs, mask="contract")
        return dx, dw, None


def expert_gemm(x, w, group_sizes: Optional[torch.Tensor] = None):
    """Fused differentiable per-expert GEMM: x (E, C, d) x w (E, d, f) ->
    (E, C, f); ``group_sizes`` (E,) marks the real rows per expert (padding
    rows are masked out of the output and the gradients)."""
    gs = None if group_sizes is None else group_sizes.detach().to(torch.int32)
    return ExpertGemm.apply(x, w, gs)
