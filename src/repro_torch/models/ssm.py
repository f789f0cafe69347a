"""Mamba2 — State Space Duality (SSD) layer (port of ``repro/models/ssm.py``).

Training and prefill use the chunked SSD algorithm: quadratic attention-like
compute inside fixed-size chunks, a linear state recurrence across chunks.
Decode uses the O(1) recurrent step form with rolling conv buffers.

The in-projection is split per stream (``wz/wx/wB/wC/wdt``), as in the
reference. The SSD scan of :func:`ssm_block` goes through
``repro_torch.kernels.dispatch.dispatch_ssd_scan`` (``plan.ssm_impl``): the
hand-written CUDA kernels on a CUDA tensor, :func:`ssd_scan` (the plain twin)
on a CPU tensor.

Four leaves are read in fp32 whatever the compute dtype (``dt_bias`` is added
to an fp32 tensor, ``A_log`` goes into ``-exp`` in fp32, ``D`` multiplies an
fp32 y, ``scale`` is read by ``rms_norm`` as ``1 + scale.float()``), so the
model holds them in fp32 (:data:`FP32_LEAVES`); the matrices and conv taps are
cast to the compute dtype at every use.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from .layers import dense_init, rms_norm

# leaves of an SSM block held in fp32 under any param dtype (module docstring)
FP32_LEAVES = ("dt_bias", "A_log", "D", "scale")


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.n_groups, s.d_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig):
    """One block's params in fp32, drawn from ``gen`` on its device."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh, g, n = ssm_dims(cfg)
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32,
                                           device=dev)

    p = {
        "wz": dense_init(gen, (d, di)),
        "wx": dense_init(gen, (d, di)),
        "wB": dense_init(gen, (d, g * n)),
        "wC": dense_init(gen, (d, g * n)),
        "wdt": dense_init(gen, (d, nh)),
    }
    # A init in [1, 16) as in the reference implementation
    a = uniform((nh,), 1.0, 16.0)
    # dt_bias: inverse softplus of a log-uniform draw in [1e-3, 1e-1]
    dt0 = torch.exp(uniform((nh,), math.log(1e-3), math.log(1e-1)))
    p.update({
        "dt_bias": torch.log(torch.expm1(dt0)),
        "A_log": torch.log(a),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "conv_x": torch.zeros((di, s.d_conv), dtype=torch.float32, device=dev),
        "conv_B": torch.zeros((g * n, s.d_conv), dtype=torch.float32, device=dev),
        "conv_C": torch.zeros((g * n, s.d_conv), dtype=torch.float32, device=dev),
        "scale": torch.zeros((di,), dtype=torch.float32, device=dev),   # gated RMSNorm
        "out_proj": dense_init(gen, (di, d)),
    })
    return p


def hold(p: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """A block's params as the model holds them: :data:`FP32_LEAVES` in fp32,
    the rest in ``dtype``."""
    return {k: v if k in FP32_LEAVES else v.to(dtype) for k, v in p.items()}


def _causal_conv(x, w, dtype, left=None):
    """Depthwise causal conv1d as a windowed sum. x: (B, L, C), w: (C, K).

    ``left`` (B, K-1, C) replaces the zero left-padding with real context (the
    context-parallel halo of the reference).
    """
    k = w.shape[-1]
    if left is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([left.to(x.dtype), x], dim=1)
    # out[:, t, c] = sum_j x[:, t+j, c] * w[c, j]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + x.shape[1], :] * w[:, j].to(dtype)
    return out


def _segsum(x):
    """x: (..., q) -> (..., q, q) with out[i, j] = sum_{k=j+1..i} x[k]; -inf above diag."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def ssd_scan(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD, the plain twin. Shapes:
      x: (b, l, h, p)   dt: (b, l, h)   A: (h,) negative   B, C: (b, l, g, n)
    Returns (y: (b, l, h, p) fp32, final_state: (b, h, p, n) fp32).
    """
    y, final, _ = ssd_scan_states(x, dt, A, B, C, chunk, initial_state)
    return y, final


def ssd_scan_states(x, dt, A, B, C, chunk: int, initial_state=None):
    """:func:`ssd_scan` that also returns the state entering each chunk,
    (b, c, h, p, n) fp32: the residual the backward kernel consumes."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of the chunk {chunk}")
    c, q = l // chunk, chunk
    hpg = h // g

    xd = (x * dt[..., None]).float()                          # discretized input
    dA = (dt * A).float()                                     # (b, l, h) log-decays

    xc = xd.reshape(b, c, q, g, hpg, p)
    Bc = B.reshape(b, c, q, g, n).float()
    Cc = C.reshape(b, c, q, g, n).float()
    dAc = dA.reshape(b, c, q, h).permute(0, 1, 3, 2)          # (b, c, h, q)
    dA_cs = torch.cumsum(dAc, dim=-1)

    # 1) intra-chunk (diagonal blocks): attention-like with decay kernel
    Ldec = torch.exp(_segsum(dAc)).reshape(b, c, g, hpg, q, q)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    y_diag = torch.einsum("bcghqk,bckghp->bcqghp", cb[:, :, :, None] * Ldec, xc)

    # 2) chunk-final states: sum_k exp(cs[-1] - cs[k]) xd[k] (x) B[k]
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)         # (b, c, h, q)
    ds = decay_states.reshape(b, c, g, hpg, q).permute(0, 1, 4, 2, 3)  # (b, c, q, g, hpg)
    states = torch.einsum("bckgn,bckghp->bcghpn", Bc, xc * ds[..., None])
    states = states.reshape(b, c, h, p, n)

    # 3) inter-chunk recurrence, emitting the state entering each chunk
    chunk_decay = torch.exp(dA_cs[..., -1])                   # (b, c, h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for ci in range(c):
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # (b, c, h, p, n)

    # 4) contribution of the carried-in state to each position
    sd = torch.exp(dA_cs).reshape(b, c, g, hpg, q).permute(0, 1, 4, 2, 3)
    pv = prev_states.reshape(b, c, g, hpg, p, n)
    y_off = torch.einsum("bcqgn,bcghpn->bcqghp", Cc, pv) * sd[..., None]

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, state, prev_states


def ssm_block(p, x, cfg: ModelConfig, dtype, initial_state=None, plan=None):
    """Full Mamba2 block forward. x: (B, L, d) -> (B, L, d): :func:`ssm_in_part`,
    the SSD scan through the dispatcher, :func:`ssm_out_part`. Unaligned lengths
    are padded to the chunk by the dispatcher, never collapsed into one
    whole-sequence chunk."""
    from repro_torch.kernels.dispatch import dispatch_ssd_scan  # noqa: PLC0415 (cycle)
    xh, dt, A, Bv, Cv, z = ssm_in_part(p, x, cfg, dtype)
    y, _ = dispatch_ssd_scan(xh, dt, A, Bv, Cv, chunk=cfg.ssm.chunk,
                             impl=plan.ssm_impl if plan is not None else "auto",
                             initial_state=initial_state)
    return ssm_out_part(p, y, xh, z, cfg, dtype)


def ssm_in_part(p, x, cfg: ModelConfig, dtype):
    """Projections, convs and discretisation: the scan's inputs in model
    layout (xh (B, L, H, P), dt (B, L, H) fp32, A (H,), B/C (B, L, G, N)) and
    the gate z."""
    s = cfg.ssm
    di, nh, g, n = ssm_dims(cfg)
    b, l, _ = x.shape
    z = x @ p["wz"].to(dtype)
    xin = x @ p["wx"].to(dtype)
    Bv = x @ p["wB"].to(dtype)
    Cv = x @ p["wC"].to(dtype)
    dt = F.softplus((x @ p["wdt"].to(dtype)).float() + p["dt_bias"])   # (b, l, nh)
    xin = F.silu(_causal_conv(xin, p["conv_x"], dtype))
    Bv = F.silu(_causal_conv(Bv, p["conv_B"], dtype))
    Cv = F.silu(_causal_conv(Cv, p["conv_C"], dtype))
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(b, l, nh, s.head_dim)
    return xh, dt, A, Bv.reshape(b, l, g, n), Cv.reshape(b, l, g, n), z


def ssm_out_part(p, y, xh, z, cfg: ModelConfig, dtype):
    """The skip term, the gated RMSNorm and the out-projection."""
    b, l = y.shape[:2]
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, l, -1).to(dtype)
    y = rms_norm(y * F.silu(z), p["scale"], cfg.rms_eps)
    return y @ p["out_proj"].to(dtype)


# ---------------------------------------------------------------------------
# decode (recurrent step form)

def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> Dict:
    s = cfg.ssm
    di, nh, g, n = ssm_dims(cfg)
    k = s.d_conv - 1
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return {
        "conv_x": z((batch, k, di), dtype),
        "conv_B": z((batch, k, g * n), dtype),
        "conv_C": z((batch, k, g * n), dtype),
        "state": z((batch, nh, s.head_dim, n), torch.float32),
    }


def _conv_step(cache_row, x_t, w, dtype):
    """cache_row: (B, K-1, C); x_t: (B, C) -> (out (B, C), new cache)."""
    window = torch.cat([cache_row, x_t[:, None, :]], dim=1)             # (B, K, C)
    out = torch.einsum("bkc,ck->bc", window.to(dtype), w.to(dtype))
    return out, window[:, 1:, :]


def ssm_step(p, x_t, cache, cfg: ModelConfig, dtype) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x_t: (B, d) -> (y (B, d), new cache). The cache is not
    modified; the caller stores the new one."""
    s = cfg.ssm
    di, nh, g, n = ssm_dims(cfg)
    bsz = x_t.shape[0]

    z = x_t @ p["wz"].to(dtype)
    xin = x_t @ p["wx"].to(dtype)
    Bv = x_t @ p["wB"].to(dtype)
    Cv = x_t @ p["wC"].to(dtype)
    dt = F.softplus((x_t @ p["wdt"].to(dtype)).float() + p["dt_bias"])  # (B, nh)

    xin, cx = _conv_step(cache["conv_x"], xin, p["conv_x"], dtype)
    Bv, cb = _conv_step(cache["conv_B"], Bv, p["conv_B"], dtype)
    Cv, cc = _conv_step(cache["conv_C"], Cv, p["conv_C"], dtype)
    xin, Bv, Cv = F.silu(xin), F.silu(Bv), F.silu(Cv)

    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                              # (B, nh)
    xh = xin.reshape(bsz, nh, s.head_dim).float()
    hpg = nh // g
    Bh = Bv.reshape(bsz, g, n).float().repeat_interleave(hpg, dim=1)    # (B, nh, n)
    Ch = Cv.reshape(bsz, g, n).float().repeat_interleave(hpg, dim=1)

    new_state = (cache["state"] * dA[..., None, None]
                 + torch.einsum("bhp,bhn->bhpn", xh * dt[..., None], Bh))
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(bsz, di).to(dtype)
    y = rms_norm(y * F.silu(z), p["scale"], cfg.rms_eps)
    y = y @ p["out_proj"].to(dtype)
    return y, {"conv_x": cx, "conv_B": cb, "conv_C": cc, "state": new_state}
