"""Roofline terms of a step on one NVIDIA H100, and the collective bytes the
port's meshes count (the port of ``repro/perf/roofline.py``).

Three terms per (arch x shape x mesh), as the reference's:

    compute    = flops / peak bf16 FLOP/s
    memory     = bytes / HBM bytes/s
    collective = link bytes / NVLink bytes/s (one direction)

The reference fills its ``hlo_flops`` and ``hlo_bytes`` from XLA's
``cost_analysis`` and its collective bytes from a walk of the optimized HLO
(``parse_collectives``, ``perf/hlo_cost.py``). The port has no HLO, so
:class:`Roofline` takes ``flops`` and ``bytes`` from the port's own
reckoning: the FLOPs of :func:`train_flops` (the matmuls, attention and SSD
scans a step needs, no recompute), and a stated floor of bytes
(:func:`train_bytes`: every byte of params, grads and both moments read once
and written once; :func:`decode_bytes`: params and cache read once). Neither
is a count of what the kernels move: the floor leaves out activations and
every re-read. The collective bytes come from the meshes themselves
(``launch.mesh``): each ``DataMesh`` and ``ModelRing`` collective adds its
count, its result's bytes and its link bytes by the ring model of
:func:`link_bytes` to a :class:`CollectiveStats`, read with
``collective_stats()``.

The constants are NVIDIA's H100 SXM data sheet figures: dense bf16 tensor-core
FLOP/s without sparsity, HBM3 bytes/s, and NVLink 4's 900 GB/s total, 450 GB/s
in each direction. They assume the card's full 700 W limit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.config import Family
from repro_torch.core.tree import leaves

PEAK_BF16_FLOPS = 989e12             # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12                 # H100 SXM HBM3
NVLINK_BYTES_PER_DIRECTION = 450e9   # H100 SXM NVLink 4: 900 GB/s total, each direction half

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


def link_bytes(kind: str, size: float, n: int) -> float:
    """Per-device bytes crossing links for one collective of ``kind`` (one of
    :data:`COLLECTIVE_KINDS`) over ``n`` ranks, by the reference's ring model
    (``parse_collectives``): ``size`` is the result's bytes (a
    reduce-scatter's block, an all-gather's gathered tensor). All-reduce
    2(n-1)/n size, all-gather and all-to-all (n-1)/n size, reduce-scatter
    (n-1) size, a ring tick (collective-permute) size; nothing for one rank."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; one of {COLLECTIVE_KINDS}")
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * frac * size
    if kind in ("all-gather", "all-to-all"):
        return frac * size
    if kind == "reduce-scatter":
        return frac * size * n
    return float(size)


@dataclasses.dataclass
class CollectiveStats:
    """Collectives by kind (the reference's fields; the port's meshes key them
    by the kinds their ``seconds`` use)."""
    counts: Dict[str, int]
    result_bytes: Dict[str, int]       # raw result sizes per kind
    link_bytes: Dict[str, float]       # ring-model per-device bytes per kind

    @classmethod
    def zeros(cls, kinds) -> "CollectiveStats":
        return cls({k: 0 for k in kinds}, {k: 0 for k in kinds}, {k: 0.0 for k in kinds})

    def add(self, kind: str, result: int, link: float) -> None:
        """One collective of ``kind``: ``result`` bytes, ``link`` link bytes."""
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.result_bytes[kind] = self.result_bytes.get(kind, 0) + result
        self.link_bytes[kind] = self.link_bytes.get(kind, 0.0) + link

    def copy(self) -> "CollectiveStats":
        return CollectiveStats(dict(self.counts), dict(self.result_bytes),
                               dict(self.link_bytes))

    def __sub__(self, before: "CollectiveStats") -> "CollectiveStats":
        """What was counted since ``before`` (an earlier copy)."""
        return CollectiveStats(
            {k: v - before.counts.get(k, 0) for k, v in self.counts.items()},
            {k: v - before.result_bytes.get(k, 0) for k, v in self.result_bytes.items()},
            {k: v - before.link_bytes.get(k, 0.0) for k, v in self.link_bytes.items()})

    @property
    def total_link_bytes(self) -> float:
        return sum(self.link_bytes.values())


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                        # per device: the port's reckoning
    bytes: float                        # per device: a stated floor (module docstring)
    collective_bytes: float             # per device: link bytes
    model_flops: float                  # 6·N(active)·D analytic, all devices
    collectives: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes / PEAK_BYTES

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / NVLINK_BYTES_PER_DIRECTION

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        if self.flops <= 0:
            return float("nan")
        return self.model_flops / (self.flops * self.chips)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collectives": self.collectives,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N_active·D (D = tokens processed per step), as the reference's."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens          # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def train_bytes(params, opt=None) -> int:
    """A train step's floor of bytes: every byte of ``params``, their grads
    (the params' dtype) and both fp32 moments read once and written once.
    ``opt`` (the moments a rank holds, e.g. its ZeRO-1 slices) counts the
    moments' real bytes instead of two fp32 copies of ``params``."""
    moments = (_nbytes(opt) if opt is not None
               else 2 * 4 * sum(t.numel() for t in leaves(params)))
    return 2 * (2 * _nbytes(params) + moments)


def decode_bytes(params, cache) -> int:
    """A decode step's floor of bytes: ``params`` and ``cache`` read once."""
    return _nbytes(params) + _nbytes(cache)


# ---------------------------------------------------------------------------
# reckoned FLOPs of a step


def ssd_flops(b, l, h, p, n, chunk, backward=False):
    """The multiply-adds x 2 an SSD pass needs on these shapes, counting only
    the causal half (j <= i) of each chunk's (q, q) products. Forward per chunk
    of q real positions: C B^T and scores (x dt) over T = q(q+1)/2 pairs, C
    state^T and the state update, 2 q P N. Backward: scores and dscores, dxd's,
    dC's and dB's (q, q) terms (T (3N + 2P)) and five (q, P, N) products."""
    total = 0
    for start in range(0, l, chunk):
        q = min(chunk, l - start)
        t = q * (q + 1) // 2
        total += t * (3 * n + 2 * p) + 5 * q * p * n if backward else \
            t * (n + p) + 2 * q * p * n
    return 2 * b * h * total


def n_apps(cfg):
    """The hybrid's shared-block applications (0 without a shared block)."""
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


def train_flops(cfg, seq, tokens, params=None, backward=True):
    """Reckoned FLOPs of one train step (forward + backward, no recompute): 6 per
    matmul parameter a token uses, plus causal attention, 6 Hq hd (S + 1) per
    token and attention layer, plus the SSD scans. With ``backward`` False, a
    forward pass (a prefill): a third of each term, the scans' forward only.
    Dense and MoE count their parameters analytically
    (``active_param_count``: for MoE the router, the top-k and shared experts;
    the embedding gather does none; a tied LM head counts once, as the head).
    The SSM and hybrid families count the model's real matrices (``params``;
    the analytic ``param_count`` omits the hybrid's shared MLP), the hybrid's
    shared block once per application, its attention on those applications
    only, and each layer's SSD forward and backward (``ssd_flops``); the
    encoder-decoder by ``encdec_train_flops``. Neither the recompute nor the
    MoE one-hot dispatch einsums are counted."""
    if cfg.is_enc_dec:
        return encdec_train_flops(cfg, seq, tokens) // (1 if backward else 3)
    n_matmul = _matmul_params(cfg, params)
    if cfg.family in (Family.SSM, Family.HYBRID):
        n_attn = n_apps(cfg)
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        b = tokens // seq
        scan = cfg.n_layers * sum(ssd_flops(b, seq, heads, s.head_dim, s.d_state, s.chunk,
                                            backward=bw) for bw in (False, True)[:1 + backward])
    else:
        n_attn, scan = cfg.n_layers, 0
    per = 6 if backward else 2
    attn = per * n_attn * cfg.n_heads * cfg.head_dim * (seq + 1)
    return (per * n_matmul + attn) * tokens + scan


def _matmul_params(cfg, params):
    """The matmul parameters a token uses, as :func:`train_flops` counts them
    (the hybrid's shared block once per application)."""
    if cfg.family in (Family.SSM, Family.HYBRID):
        n = sum(t.numel() for lp in params["layers"] for t in leaves(lp) if t.dim() > 1)
        if n_apps(cfg):
            n += n_apps(cfg) * sum(t.numel() for t in leaves(params["shared_attn"])
                                   if t.dim() > 1)
        return n + (params["lm_head"]["w"] if "lm_head" in params
                    else params["embed"]["tok"]).numel()
    n = cfg.active_param_count() - cfg.vocab * cfg.d_model
    return n + (cfg.vocab * cfg.d_model if cfg.tie_embeddings else 0)


def decode_flops(cfg, rows, t, params=None):
    """Reckoned FLOPs of one decode step of ``rows`` sequences whose new token
    attends ``t`` positions: 2 per matmul parameter a token uses (as
    :func:`train_flops` counts them), 4 hd per attended position and head on
    each attention layer (a local layer's window caps its positions), and on
    the SSM layers 6 H P N per token (the state's decay, its update and its
    readout). The encoder-decoder: the decoder's matmuls but the cross keys
    and values (filled once), self-attention over ``t`` and cross-attention
    over the frames."""
    hd, hq = cfg.head_dim, cfg.n_heads
    if cfg.is_enc_dec:
        d = cfg.d_model
        kv = 2 * d * cfg.n_kv_heads * hd
        # self q/k/v/o, cross q/o, the MLP; the head
        per_token = cfg.n_layers * (2 * (2 * d * hq * hd + kv) - kv + 3 * d * cfg.d_ff) \
            + d * cfg.vocab
        return rows * (2 * per_token + 4 * hq * hd * cfg.n_layers * (t + cfg.enc_frames))
    if cfg.family in (Family.SSM, Family.HYBRID):
        s = cfg.ssm
        heads = s.expand * cfg.d_model // s.head_dim
        return rows * (2 * _matmul_params(cfg, params) + 4 * hq * hd * n_apps(cfg) * t
                       + 6 * cfg.n_layers * heads * s.head_dim * s.d_state)
    alternating = cfg.local_global_alternating and cfg.sliding_window and not cfg.long_context
    attended = 0
    for i in range(cfg.n_layers):
        w = (cfg.sliding_window if i % 2 == 0 else 0) if alternating else cfg.sliding_window
        attended += min(t, w) if w else t
    return rows * (2 * _matmul_params(cfg, params) + 4 * hq * hd * attended)


def encdec_train_flops(cfg, seq, tokens):
    """Reckoned FLOPs of one encoder-decoder train step (forward + backward, no
    recompute): 6 per matmul parameter a frame or a token uses (the encoder's
    layers and every decoder layer's cross keys and values on the frames; the
    decoder's self-attention, cross queries and output, MLP and the LM head on
    the tokens; the embedding gather does none), plus 12 hd FLOP per attended
    (query, key) pair and head: the encoder's non-causal F^2, the decoder's
    causal S(S+1)/2 and the cross-attention's S F, per sequence."""
    d, f, hd = cfg.d_model, cfg.enc_frames, cfg.head_dim
    kv = 2 * d * cfg.n_kv_heads * hd
    attn = 2 * d * cfg.n_heads * hd + kv
    mlp = 3 * d * cfg.d_ff
    b = tokens // seq
    per_frame = cfg.enc_layers * (attn + mlp) + cfg.n_layers * kv
    per_token = cfg.n_layers * (2 * attn - kv + mlp) + d * cfg.vocab
    pairs = cfg.enc_layers * f * f + cfg.n_layers * (seq * (seq + 1) // 2 + seq * f)
    return 6 * (per_frame * b * f + per_token * tokens) + 12 * cfg.n_heads * hd * b * pairs
