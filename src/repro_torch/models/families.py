"""Model assembly: the dense decoder and its MoE and VLM variants, the Mamba2
SSM, the zamba2 hybrid and the whisper encoder-decoder (port of
``repro/models/families.py``).

``build_model`` returns a :class:`Model` with the reference's API:

- ``init(gen) -> params``
- ``forward(params, batch) -> (logits, aux)``            (parallel pass)
- ``init_cache(batch, max_seq) -> cache``                 (zeros)
- ``prefill(params, batch, max_seq) -> (logits, cache)``  (prompt + KV cache;
  decoders only: the reference's SSM and hybrid models have none, and serve a
  prompt through ``decode_step``; the encoder-decoder serves through
  ``fill_cross`` then ``decode_step``)
- ``decode_step(params, cache, tokens, pos) -> (logits, cache)``

Params are nested dicts of tensors with the reference's leaf names; ``layers``
is a list of per-layer dicts (the reference stacks them on a leading L dim and
scans). Layers run as a Python loop, so each layer's sliding window is a plain
``int``, and ``plan.remat`` applies per decoder layer (``train/executor.py``).
Matrices, biases and embeddings are held in ``plan.param_dtype`` (fp32 masters
by default, as in the reference) and cast to the compute dtype at every use;
a serving run asks for ``param_dtype="bfloat16"``, the same bits as the cast
in half the memory. Norm scales stay fp32, as ``rms_norm`` reads them. The KV
cache is written in place. A MoE layer's router and experts (``models/moe.py``)
are held like the other matrices. An SSM block holds ``dt_bias``, ``A_log``,
``D`` and its gated-norm ``scale`` in fp32 (``models/ssm.py``). The
encoder-decoder (:class:`EncDecModel`) adds ``encode`` and ``fill_cross``.

Serving on a (data, model) grid (``build_model(cfg, plan, mesh=grid)``, the
reference's ``mesh`` and ``batch_axes``; survey §4.1.4): every model rank
holds the whole params. The entry points take the global batch and serve
this rank's rows of it: the rows of its data index where the batch divides
(``launch.mesh.batch_axes_for``; the data x model ranks under
``dp_over_model``), every row otherwise. ``init_cache`` allocates this rank's
part of the cache as ``core.sharding.cache_specs`` lays it out: its rows
and, with ``plan.seq_shard_decode``, the positions ``[r T_loc, (r + 1)
T_loc)`` of the K/V caches (``seq_block``); ``decode_step`` then runs the
sharded branch of ``serve.attention.decode_attention`` over the model ring,
after which every model rank holds the same residual and the same logits.
``prefill`` under ``plan.seq_shard_attn`` runs model rank r's contiguous
query chunk of the prompt with K/V all-gathered over the model ring (the
executor's ``gather_attention`` with that ring as its cp ring: B1 at
``q_offset = r S/M``), writes the positions it owns of the gathered K/V into
its cache part, and returns its chunk's logits (B, S/M, V): the whole
sequence's fp32 logits would not fit at a large vocabulary. A prompt whose
length the axis does not divide, or shorter than the axis, runs whole on
every rank (the reference's no-op rule). ``last_logits`` hands the last
position's row to every rank; ``seq_chunk`` says which rows a rank holds.
The SSM family runs its decode whole on every model rank (its state and
conv tails whole); whisper's encoder and ``fill_cross`` run whole there.

ZeRO-3 (``plan.dp_shard`` > 1 with ``mesh`` a data mesh or a grid under
``dp_over_model``): ``forward`` takes this rank's parts of the params
(``core.sharding.fsdp_cut``) and gathers each layer's inside its remat
boundary (``train/fsdp.py``), the embedding, final norm and head where they
are used.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.config import Family, ModelConfig, ParallelPlan
from repro_torch.core.device import resolve_device, resolve_dtype
from repro_torch.core.sharding import cache_specs, seq_block
from repro_torch.core.tree import map_tree
from repro_torch.launch.mesh import batch_axes_for, data_mesh, model_size
from repro_torch.serve import attention as serve_attention
from .layers import (dense_init, init_attn, init_mlp, mlp_block, qkv_proj,
                     rms_norm, rope, sinusoidal_pos_emb)
from .moe import init_moe, moe_block
from . import ssm as ssm_lib


def _layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer sliding-window size (0 = full attention)."""
    if cfg.local_global_alternating and cfg.sliding_window and not cfg.long_context:
        # even layers local (gemma2)
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def _padded_vocab(cfg: ModelConfig, plan: Optional[ParallelPlan]) -> int:
    m = plan.pad_vocab_to_multiple if plan else 0
    if not m:
        return cfg.vocab
    return -(-cfg.vocab // m) * m


def _logits(params, x, cfg: ModelConfig, dtype):
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(dtype).T
    else:
        w = params["lm_head"]["w"].to(dtype)
    logits = x @ w
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    logits = logits.float()
    vp = logits.shape[-1]
    if vp != cfg.vocab:
        # Megatron-style padded vocab: mask the padded tail out of the softmax
        pad_mask = torch.arange(vp, device=logits.device) >= cfg.vocab
        logits = torch.where(pad_mask, -1e9, logits)
    return logits


def head_params(params, cfg: ModelConfig):
    """The leaves ``_logits`` reads: the tied embedding or the LM head."""
    return {"embed": params["embed"]} if cfg.tie_embeddings else {"lm_head": params["lm_head"]}


class KVCache(dict):
    """A decode cache on a grid: the dict of its tensors (this rank's parts),
    and ``seq_sharded``, whether its K/V leaves hold the rank's block of
    positions (``cache_specs``) rather than the whole sequence."""
    seq_sharded: bool = False


class Placement:
    """How a model serves on ``mesh`` under ``plan`` (module docstring): the
    model ring that shards the cache's sequence and the prefill's queries
    (None: no such ring, or ``dp_over_model``), the data group whose ranks
    split the batch's rows, and ZeRO-3's gather (None without
    ``dp_shard`` > 1). ``batch_axes``: None follows the reference's
    ``batch_axes_for`` on each batch, () keeps every row on every rank."""

    def __init__(self, mesh, plan: ParallelPlan, batch_axes=None):
        from repro_torch.train.fsdp import gatherer  # noqa: PLC0415 (import cycle)
        self.mesh, self.plan, self.batch_axes = mesh, plan, batch_axes
        self.ring = (mesh.model if mesh is not None and model_size(mesh) > 1
                     and not plan.dp_over_model else None)
        self.data = data_mesh(mesh) if mesh is not None else None
        self.gather = (gatherer(self.data) if self.data is not None and plan.dp_shard > 1
                       else None)

    def axes(self, rows: int):
        """The mesh axes the batch of ``rows`` shards over: the reference's
        rule, all or nothing over the data domain (the port has no partial
        split of it)."""
        if self.mesh is None or self.data is None or self.data.size == 1:
            return ()
        want = ("data", "model") if self.plan.dp_over_model else ("data",)
        axes = (batch_axes_for(self.mesh, rows, dp_over_model=self.plan.dp_over_model)
                if self.batch_axes is None else tuple(self.batch_axes))
        if axes and (rows % self.data.size or tuple(a for a in want if a in axes) != want):
            if self.batch_axes is not None:
                raise ValueError(f"batch_axes {axes} do not split {rows} rows over the "
                                 f"data domain of {self.data.size} ranks")
            return ()
        return want if axes else ()

    def rows(self, rows: int):
        """This rank's rows [lo, hi) of a global batch of ``rows``."""
        if not self.axes(rows):
            return 0, rows
        k = rows // self.data.size
        return self.data.rank * k, (self.data.rank + 1) * k

    def take(self, t, rows: Optional[int] = None):
        """This rank's rows of ``t`` (a global batch's tensor; ``rows`` when
        ``t`` may already hold only this rank's: then it is returned)."""
        lo, hi = self.rows(t.shape[0] if rows is None else rows)
        return t if t.shape[0] == hi - lo else t[lo:hi]

    def seq_chunk(self, s: int):
        """The prompt positions [lo, hi) this rank's prefill runs (module
        docstring)."""
        if self.ring is None or not self.plan.seq_shard_attn or s % self.ring.size \
                or s < self.ring.size:
            return 0, s
        k = s // self.ring.size
        return self.ring.rank * k, (self.ring.rank + 1) * k

    def alloc(self, shapes, rows: int, dtype_of, device):
        """A cache of whole ``shapes`` ({name: (L, B, ...)}; nested dicts as
        the cache's; ``rows`` the global batch B) allocated as this rank's
        parts (``cache_specs``): zeros, a :class:`KVCache` on a grid."""
        meta = _map_named(shapes, lambda _, sh: torch.empty(sh, device="meta"))
        specs = cache_specs(meta, self.plan, self.mesh, self.axes(rows))
        sharded = False

        def part(name, shape):
            nonlocal sharded
            shape = list(shape)
            spec = specs[name]
            if spec[1] is not None:
                shape[1] //= self.data.size
            if "model" in spec and self.ring is not None:
                shape[2] //= self.ring.size
                sharded = True
            return torch.zeros(shape, dtype=dtype_of(name), device=device)
        out = _map_named(shapes, part)
        if self.mesh is None:
            return out
        cache = KVCache(out)
        cache.seq_sharded = sharded
        return cache

    def decode_mesh(self, cache):
        """The mesh ``decode_attention`` shards over: the grid when the
        cache's K/V hold the rank's block of positions."""
        return self.mesh if getattr(cache, "seq_sharded", False) else None

    def last_logits(self, logits, s: int):
        """The prompt's last position's logits (B, V) on every rank, from a
        prefill's ``logits`` (this rank's chunk when sharded): one (B, V)
        hop over the model ring (the last rank's row, zeros elsewhere)."""
        lo, hi = self.seq_chunk(s)
        if hi - lo == s:
            return logits[:, -1]
        row = logits[:, -1]
        last = self.ring.rank == self.ring.size - 1
        return self.ring.all_reduce_sum(row if last else torch.zeros_like(row))

    def write_kv(self, cache, cache_k, cache_v, k, v):
        """One layer's prompt K/V (B, S, Hkv, hd), positions [0, S), into its
        parts of ``cache`` (``cache_k``/``cache_v``, (B, T_here, ...)): the
        positions this rank owns."""
        t_here = cache_k.shape[1]
        start = (seq_block(t_here, self.ring.rank)[0]
                 if getattr(cache, "seq_sharded", False) else 0)
        stop = min(k.shape[1], start + t_here)
        if start < stop:
            cache_k[:, :stop - start] = k[:, start:stop]
            cache_v[:, :stop - start] = v[:, start:stop]


def _map_named(tree, fn, prefix=""):
    """``tree`` (nested dicts) with every leaf replaced by ``fn(name, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _embed(params, tokens, cfg: ModelConfig, dtype):
    x = params["embed"]["tok"][tokens].to(dtype)
    if cfg.scale_embed:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
    return x


def _zero_norm(cfg: ModelConfig, gen: torch.Generator):
    """A norm's params: its fp32 scale, zeros (the reference's init)."""
    return {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)}


def _init_decoder_layer(cfg: ModelConfig, gen: torch.Generator, dtype):
    """One layer's params: matrices and biases in ``dtype``, norm scales fp32.
    Drawn in fp32 and cast one layer at a time, so fp32 copies of the whole
    model never coexist with the compute-dtype copy."""
    p = {
        "norm1": _zero_norm(cfg, gen),
        "norm2": _zero_norm(cfg, gen),
        "attn": {k: w.to(dtype) for k, w in init_attn(gen, cfg).items()},
    }
    if cfg.post_norm:
        p["norm1_post"] = _zero_norm(cfg, gen)
        p["norm2_post"] = _zero_norm(cfg, gen)
    if cfg.family == Family.MOE:
        p["moe"] = map_tree(lambda w: w.to(dtype), init_moe(gen, cfg))
    else:
        p["mlp"] = {k: w.to(dtype) for k, w in
                    init_mlp(gen, cfg.d_model, cfg.d_ff).items()}
    return p


class Model:
    """The dense / MoE / VLM decoder (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                 device=None, mesh=None, batch_axes=None):
        from repro_torch.train import executor as exlib  # noqa: PLC0415 (import cycle)
        self.cfg = cfg
        self.plan = plan or ParallelPlan()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.plan.compute_dtype)
        self.param_dtype = resolve_dtype(self.plan.param_dtype)
        self.windows = _layer_windows(cfg)
        self.mesh = mesh
        self.place = Placement(mesh, self.plan, batch_axes)
        self._layer = exlib.decoder_layer(exlib.local_context(self.place.gather), cfg,
                                          self.plan, self.dtype)
        self._layer_kv = exlib.decoder_layer(exlib.local_context(), cfg, self.plan,
                                             self.dtype, collect_kv=True)
        if self.place.ring is not None:
            # the grid prefill: the model ring as the gather mode's cp ring
            grid = exlib.ParallelContext(cp=self.place.ring, cp_impl="gather")
            self._layer_kv_grid = exlib.decoder_layer(grid, cfg, self.plan, self.dtype,
                                                      collect_kv=True)

    def _full(self, tree):
        return tree if self.place.gather is None else self.place.gather(tree)

    # -- params ------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params drawn from ``gen`` (a generator on ``self.device``),
        held in ``plan.param_dtype`` (norm scales fp32)."""
        cfg, dtype = self.cfg, self.param_dtype
        vp = _padded_vocab(cfg, self.plan)
        params = {
            "embed": {"tok": dense_init(gen, (vp, cfg.d_model), in_axis=-1).to(dtype)},
            "layers": [_init_decoder_layer(cfg, gen, dtype)
                       for _ in range(cfg.n_layers)],
            "final_norm": _zero_norm(cfg, gen),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": dense_init(gen, (cfg.d_model, vp)).to(dtype)}
        return params

    # -- shared pieces ------------------------------------------------------

    def _inputs(self, params, batch):
        """Embedded tokens (+ VLM patch scatter, + sinusoidal positions)."""
        cfg, dtype = self.cfg, self.dtype
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed({"embed": self._full(params["embed"])}, tokens, cfg, dtype)
        if cfg.family == Family.VLM and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(dtype)            # (B, N_img, d)
            vp = batch["vision_pos"]                         # (B, N_img)
            x[torch.arange(b, device=x.device)[:, None], vp] = ve
        positions = torch.arange(s, device=x.device)
        if cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal_pos_emb(positions, cfg.d_model).to(dtype)
        return x, positions

    def _head(self, params, x):
        x = rms_norm(x, self._full(params["final_norm"])["scale"], self.cfg.rms_eps)
        return _logits(self._full(head_params(params, self.cfg)), x, self.cfg, self.dtype)

    # -- entry points -------------------------------------------------------

    def forward(self, params, batch):
        x, positions = self._inputs(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, w in zip(params["layers"], self.windows):
            x, a = self._layer(x, lp, w, positions)
            aux = aux + a
        return self._head(params, x), aux

    def init_cache(self, batch: int, max_seq: int):
        """Zeros for ``batch`` sequences of ``max_seq`` positions: on a grid
        this rank's part (module docstring)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return self.place.alloc({"k": shape, "v": shape}, batch, lambda _: self.dtype,
                                self.device)

    @torch.no_grad()
    def prefill(self, params, batch, max_seq: int):
        """Process a prompt in parallel and return (logits, filled cache).

        The serving flow: prefill once (full forward, KV emitted per layer) then
        call decode_step from position S onward. Serving records no autograd
        graph, so ``plan.remat`` does not apply here. On a grid: this rank's
        rows, and under ``seq_shard_attn`` its chunk of the prompt's
        positions (``seq_chunk``; module docstring).
        """
        rows, s = batch["tokens"].shape
        if s > max_seq:
            raise ValueError(f"prompt length {s} exceeds max_seq {max_seq}")
        batch = {k: self.place.take(v, rows) for k, v in batch.items()}
        x, positions = self._inputs(params, batch)
        cache = self.init_cache(rows, max_seq)
        lo, hi = self.place.seq_chunk(s)
        layer = self._layer_kv
        if hi - lo < s:
            x, positions, layer = x[:, lo:hi], positions[lo:hi], self._layer_kv_grid
        for i, (lp, w) in enumerate(zip(params["layers"], self.windows)):
            x, _, (k, v) = layer(x, lp, w, positions)
            self.place.write_kv(cache, cache["k"][i], cache["v"][i], k, v)
        return self._head(params, x), cache

    def seq_chunk(self, s: int):
        """The prompt positions [lo, hi) whose logits this rank's prefill of
        a prompt of ``s`` tokens returns."""
        return self.place.seq_chunk(s)

    def last_logits(self, logits, s: int):
        """The last prompt position's logits (B, V) on every rank, from
        ``prefill``'s logits of a prompt of ``s`` tokens."""
        return self.place.last_logits(logits, s)

    def decode_step(self, params, cache, tokens, pos: int):
        """One token per sequence at position ``pos``; writes the cache in
        place. On a grid ``tokens`` may be the global batch's or this rank's
        rows; the logits are this rank's rows, the same on every model rank."""
        cfg, dtype = self.cfg, self.dtype
        tokens = self.place.take(tokens) if cache["k"].shape[1] != tokens.shape[0] else tokens
        b = tokens.shape[0]
        mesh = self.place.decode_mesh(cache)
        x = _embed(params, tokens, cfg, dtype)[:, None, :]   # (B, 1, d)
        positions = torch.full((1,), pos, device=x.device)
        if cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal_pos_emb(positions, cfg.d_model).to(dtype)[None]
        for i, (lp, w) in enumerate(zip(params["layers"], self.windows)):
            h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
            q, k, v = qkv_proj(lp["attn"], h, cfg, dtype)
            if cfg.pos_emb == "rope":
                q = rope(q, positions, cfg.rope_theta)
                k = rope(k, positions, cfg.rope_theta)
            a, _, _ = serve_attention.decode_attention(
                q, cache["k"][i], cache["v"][i], k, v, pos, window=w,
                softcap=cfg.attn_logit_softcap, mesh=mesh)
            a = a.reshape(b, 1, -1) @ lp["attn"]["wo"].to(dtype)
            if cfg.post_norm:
                a = rms_norm(a, lp["norm1_post"]["scale"], cfg.rms_eps)
            x = x + a
            h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
            if cfg.family == Family.MOE:
                m, _ = moe_block(lp["moe"], h, cfg, dtype, self.plan)
            else:
                m = mlp_block(lp["mlp"], h, dtype)
            if cfg.post_norm:
                m = rms_norm(m, lp["norm2_post"]["scale"], cfg.rms_eps)
            x = x + m
        x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
        return _logits(params, x[:, 0, :], cfg, dtype), cache


class SSMModel:
    """The Mamba2 SSM (the reference's ``build_ssm``): embedding, the Mamba2
    layers (``train/executor.ssm_layer``, ``plan.remat`` per layer),
    ``final_norm``, the tied (or separate) LM head. The decode cache stacks the
    per-layer conv buffers and fp32 states on a leading layer dim, as the
    reference does, and is written in place."""

    def __init__(self, cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                 device=None, mesh=None, batch_axes=None):
        from repro_torch.train import executor as exlib  # noqa: PLC0415 (import cycle)
        self.cfg = cfg
        self.plan = plan or ParallelPlan()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.plan.compute_dtype)
        self.param_dtype = resolve_dtype(self.plan.param_dtype)
        self.mesh = mesh
        self.place = Placement(mesh, self.plan, batch_axes)
        self._layer = exlib.ssm_layer(exlib.local_context(self.place.gather), cfg, self.plan,
                                      self.dtype)

    def _full(self, tree):
        return tree if self.place.gather is None else self.place.gather(tree)

    def _init_layers(self, gen):
        return [{"norm1": _zero_norm(self.cfg, gen),
                 "ssm": ssm_lib.hold(ssm_lib.init_ssm(gen, self.cfg), self.param_dtype)}
                for _ in range(self.cfg.n_layers)]

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        cfg, dtype = self.cfg, self.param_dtype
        vp = _padded_vocab(cfg, self.plan)
        params = {
            "embed": {"tok": dense_init(gen, (vp, cfg.d_model), in_axis=-1).to(dtype)},
            "layers": self._init_layers(gen),
            "final_norm": _zero_norm(self.cfg, gen),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"w": dense_init(gen, (cfg.d_model, vp)).to(dtype)}
        return params

    def _head(self, params, x):
        x = rms_norm(x, self._full(params["final_norm"])["scale"], self.cfg.rms_eps)
        return _logits(self._full(head_params(params, self.cfg)), x, self.cfg, self.dtype)

    def forward(self, params, batch):
        x = _embed({"embed": self._full(params["embed"])}, batch["tokens"], self.cfg,
                   self.dtype)
        for lp in params["layers"]:
            x, _ = self._layer(x, lp)
        return self._head(params, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    def _ssm_shapes(self, batch: int):
        """{name: ((L, B, ...), dtype)} of the stacked SSM decode cache."""
        one = ssm_lib.init_ssm_cache(self.cfg, batch, self.dtype, "meta")
        return {k: ((self.cfg.n_layers,) + tuple(v.shape), v.dtype) for k, v in one.items()}

    def init_cache(self, batch: int, max_seq: int):
        """The per-layer conv buffers and fp32 states stacked, zeros; on a
        grid this rank's rows, whole on every model rank (module docstring)."""
        shapes = self._ssm_shapes(batch)
        return self.place.alloc({k: sh for k, (sh, _) in shapes.items()}, batch,
                                lambda n: shapes[n][1], self.device)

    def _ssm_step(self, x, lp, cache, i):
        """One layer's decode step; writes layer ``i`` of the cache in place."""
        h = rms_norm(x, lp["norm1"]["scale"], self.cfg.rms_eps)
        y, new = ssm_lib.ssm_step(lp["ssm"], h, {k: v[i] for k, v in cache.items()},
                                  self.cfg, self.dtype)
        for k, v in new.items():
            cache[k][i].copy_(v)
        return x + y

    def _rows(self, tokens, cache_rows: int):
        return self.place.take(tokens) if cache_rows != tokens.shape[0] else tokens

    def decode_step(self, params, cache, tokens, pos: int):
        """One token per sequence (``pos`` is not read: the state carries it);
        on a grid the global batch's or this rank's rows, as ``Model``'s."""
        tokens = self._rows(tokens, next(iter(cache.values())).shape[1])
        x = _embed(params, tokens, self.cfg, self.dtype)                # (B, d)
        for i, lp in enumerate(params["layers"]):
            x = self._ssm_step(x, lp, cache, i)
        return self._head(params, x), cache


class HybridModel(SSMModel):
    """The zamba2 hybrid (the reference's ``build_hybrid``): the Mamba2 layers
    in ``n_apps`` groups of ``shared_attn_every``, each group followed by one
    weight-shared block (norm1, attention through ``dispatch_attention``,
    ``wo``, norm2, SwiGLU MLP), then the ``rest`` tail layers; ``lm_head`` is
    always present. As in the reference, ``plan.remat`` applies to the SSM
    layers only, not to the shared block. The decode cache adds the shared
    block's K/V per application, (n_apps, B, max_seq, Hkv, hd), written in
    place by ``decode_attention``."""

    def __init__(self, cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                 device=None, mesh=None, batch_axes=None):
        super().__init__(cfg, plan, device=device, mesh=mesh, batch_axes=batch_axes)
        self.every = cfg.shared_attn_every
        self.n_apps = cfg.n_layers // self.every
        self.covered = self.n_apps * self.every

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        cfg, dtype = self.cfg, self.param_dtype
        vp = _padded_vocab(cfg, self.plan)
        return {
            "embed": {"tok": dense_init(gen, (vp, cfg.d_model), in_axis=-1).to(dtype)},
            "layers": self._init_layers(gen),
            "shared_attn": {
                "norm1": _zero_norm(self.cfg, gen),
                "norm2": _zero_norm(self.cfg, gen),
                "attn": {k: w.to(dtype) for k, w in init_attn(gen, cfg).items()},
                "mlp": {k: w.to(dtype) for k, w in
                        init_mlp(gen, cfg.d_model, cfg.d_ff).items()},
            },
            "final_norm": _zero_norm(self.cfg, gen),
            "lm_head": {"w": dense_init(gen, (cfg.d_model, vp)).to(dtype)},
        }

    def _groups(self, layers):
        """(group index or None for the tail, that group's layer indices)."""
        for gi in range(self.n_apps):
            yield gi, range(gi * self.every, (gi + 1) * self.every)
        yield None, range(self.covered, len(layers))

    def _shared(self, sp, x, positions):
        cfg, dtype = self.cfg, self.dtype
        from repro_torch.kernels.dispatch import dispatch_attention  # noqa: PLC0415 (cycle)
        sp = self._full(sp)
        h = rms_norm(x, sp["norm1"]["scale"], cfg.rms_eps)
        q, k, v = qkv_proj(sp["attn"], h, cfg, dtype)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        a = dispatch_attention(q, k, v, impl=self.plan.attn_impl, causal=True,
                               window=cfg.sliding_window)
        x = x + a.reshape(x.shape[0], x.shape[1], -1) @ sp["attn"]["wo"].to(dtype)
        h = rms_norm(x, sp["norm2"]["scale"], cfg.rms_eps)
        return x + mlp_block(sp["mlp"], h, dtype)

    def forward(self, params, batch):
        tokens = batch["tokens"]
        x = _embed({"embed": self._full(params["embed"])}, tokens, self.cfg, self.dtype)
        positions = torch.arange(tokens.shape[1], device=x.device)
        layers = params["layers"]
        for gi, idx in self._groups(layers):
            for i in idx:
                x, _ = self._layer(x, layers[i])
            if gi is not None:
                x = self._shared(params["shared_attn"], x, positions)
        return self._head(params, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    def init_cache(self, batch: int, max_seq: int):
        """The SSM cache under ``ssm`` and the shared block's K/V per
        application; on a grid this rank's part (module docstring)."""
        cfg = self.cfg
        ssm = self._ssm_shapes(batch)
        shape = (self.n_apps, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        shapes = {"ssm": {k: sh for k, (sh, _) in ssm.items()}, "attn_k": shape,
                  "attn_v": shape}
        return self.place.alloc(
            shapes, batch, lambda n: ssm[n[4:]][1] if n.startswith("ssm/") else self.dtype,
            self.device)

    def _shared_step(self, sp, x, kc, vc, pos, mesh=None):
        cfg, dtype = self.cfg, self.dtype
        positions = torch.full((1,), pos, device=x.device)
        xs = x[:, None, :]
        h = rms_norm(xs, sp["norm1"]["scale"], cfg.rms_eps)
        q, k, v = qkv_proj(sp["attn"], h, cfg, dtype)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        a, _, _ = serve_attention.decode_attention(q, kc, vc, k, v, pos,
                                                   window=cfg.sliding_window, mesh=mesh)
        xs = xs + a.reshape(a.shape[0], 1, -1) @ sp["attn"]["wo"].to(dtype)
        h = rms_norm(xs, sp["norm2"]["scale"], cfg.rms_eps)
        return (xs + mlp_block(sp["mlp"], h, dtype))[:, 0, :]

    def decode_step(self, params, cache, tokens, pos: int):
        """One token per sequence at position ``pos``; writes the cache in
        place. On a grid the shared block's K/V are sequence-sharded
        (``decode_attention``'s sharded branch), the SSM state whole."""
        tokens = self._rows(tokens, cache["attn_k"].shape[1])
        mesh = self.place.decode_mesh(cache)
        x = _embed(params, tokens, self.cfg, self.dtype)                # (B, d)
        layers = params["layers"]
        for gi, idx in self._groups(layers):
            for i in idx:
                x = self._ssm_step(x, layers[i], cache["ssm"], i)
            if gi is not None:
                x = self._shared_step(params["shared_attn"], x, cache["attn_k"][gi],
                                      cache["attn_v"][gi], pos, mesh)
        return self._head(params, x), cache


class EncDecModel:
    """The whisper encoder-decoder (the reference's ``build_enc_dec``): the
    frame-embedding frontend stub (frames arrive as (B, F, d) embeddings),
    ``enc_layers`` encoder layers with non-causal self-attention
    (``train/executor.encoder_layer``), the encoder's ``final_norm``, then
    ``n_layers`` decoder layers with causal self-attention and cross-attention
    to the encoder output (``train/executor.cross_decoder_layer``). Positions
    are sinusoidal on both sides. ``plan.remat`` applies per encoder and per
    decoder layer. There is no ``prefill``: serving is :meth:`fill_cross`
    (the encoder, then every layer's cross keys and values into the cache)
    followed by :meth:`decode_step`, whose cross-attention goes through the
    dispatcher at S = 1 against the cached ``cross_k``/``cross_v``."""

    def __init__(self, cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                 device=None, mesh=None, batch_axes=None):
        from repro_torch.train import executor as exlib  # noqa: PLC0415 (import cycle)
        self.cfg = cfg
        self.plan = plan or ParallelPlan()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.plan.compute_dtype)
        self.param_dtype = resolve_dtype(self.plan.param_dtype)
        self.mesh = mesh
        self.place = Placement(mesh, self.plan, batch_axes)
        gather = self.place.gather
        self._enc_layer = exlib.encoder_layer(cfg, self.plan, self.dtype, gather)
        self._dec_layer = exlib.cross_decoder_layer(cfg, self.plan, self.dtype, gather)
        self._cross_kv = functools.partial(exlib.cross_kv, cfg, dtype=self.dtype)

    def _full(self, tree):
        return tree if self.place.gather is None else self.place.gather(tree)

    def _held(self, tree):
        return {k: w.to(self.param_dtype) for k, w in tree.items()}

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params drawn from ``gen``, the reference's tree: matrices in
        ``plan.param_dtype``, norm scales fp32 zeros."""
        cfg = self.cfg
        vp = _padded_vocab(cfg, self.plan)
        embed = {"tok": dense_init(gen, (vp, cfg.d_model), in_axis=-1).to(self.param_dtype)}
        norms = lambda *names: {n: _zero_norm(cfg, gen) for n in names}  # noqa: E731
        enc = [{**norms("norm1", "norm2"),
                "attn": self._held(init_attn(gen, cfg)),
                "mlp": self._held(init_mlp(gen, cfg.d_model, cfg.d_ff))}
               for _ in range(cfg.enc_layers)]
        dec = [{**norms("norm1", "norm2", "norm3"),
                "attn": self._held(init_attn(gen, cfg)),
                "xattn": self._held(init_attn(gen, cfg)),
                "mlp": self._held(init_mlp(gen, cfg.d_model, cfg.d_ff))}
               for _ in range(cfg.n_layers)]
        return {
            "embed": embed,
            "encoder": {"layers": enc, **norms("final_norm")},
            "layers": dec,
            **norms("final_norm"),
            "lm_head": {"w": dense_init(gen, (cfg.d_model, vp)).to(self.param_dtype)},
        }

    def _positions(self, x, start: int = 0):
        """x plus sinusoidal positions ``start .. start + S - 1`` (x: (B, S, d))."""
        pos = torch.arange(start, start + x.shape[1], device=x.device)
        return x + sinusoidal_pos_emb(pos, self.cfg.d_model).to(self.dtype)

    def encode(self, params, frames):
        """(B, F, d) frame embeddings -> the encoder output (B, F, d)."""
        x = self._positions(frames.to(self.dtype))
        for lp in params["encoder"]["layers"]:
            x = self._enc_layer(x, lp)
        scale = self._full(params["encoder"]["final_norm"])["scale"]
        return rms_norm(x, scale, self.cfg.rms_eps)

    def _head(self, params, x):
        x = rms_norm(x, self._full(params["final_norm"])["scale"], self.cfg.rms_eps)
        return _logits(self._full(head_params(params, self.cfg)), x, self.cfg, self.dtype)

    def forward(self, params, batch):
        """``batch``: tokens (B, S) and frames (B, F, d) -> (logits, 0)."""
        enc_out = self.encode(params, batch["frames"])
        x = self._positions(_embed({"embed": self._full(params["embed"])}, batch["tokens"],
                                   self.cfg, self.dtype))
        for lp in params["layers"]:
            x = self._dec_layer(x, lp, enc_out)
        return self._head(params, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    def init_cache(self, batch: int, max_seq: int):
        """Self-attention K/V (L, B, max_seq, Hkv, hd) and cross K/V (L, B,
        enc_frames, Hkv, hd), zeros in the compute dtype; on a grid this
        rank's part (the cross K/V whole over the model ranks)."""
        cfg = self.cfg
        tail = (cfg.n_kv_heads, cfg.head_dim)
        shape = lambda n: (cfg.n_layers, batch, n) + tail  # noqa: E731
        return self.place.alloc({"k": shape(max_seq), "v": shape(max_seq),
                                 "cross_k": shape(cfg.enc_frames),
                                 "cross_v": shape(cfg.enc_frames)},
                                batch, lambda _: self.dtype, self.device)

    @torch.no_grad()
    def fill_cross(self, params, cache, frames):
        """Run the encoder on ``frames`` (B, enc_frames, d; on a grid the
        global batch's or this rank's rows) and write every decoder layer's
        cross keys and values into ``cache`` in place."""
        if frames.shape[1] != cache["cross_k"].shape[2]:
            raise ValueError(f"{frames.shape[1]} frames, the cache holds "
                             f"{cache['cross_k'].shape[2]}")
        if frames.shape[0] != cache["cross_k"].shape[1]:
            frames = self.place.take(frames)
        enc_out = self.encode(params, frames)
        for i, lp in enumerate(params["layers"]):
            k, v = self._cross_kv(lp, enc_out)
            cache["cross_k"][i] = k
            cache["cross_v"][i] = v
        return cache

    def decode_step(self, params, cache, tokens, pos: int):
        """One token per sequence at position ``pos``: self-attention through
        the plain ``decode_attention`` (the cache written in place), then
        cross-attention to the cached encoder K/V through the dispatcher."""
        from repro_torch.kernels.dispatch import dispatch_attention  # noqa: PLC0415 (cycle)
        cfg, dtype = self.cfg, self.dtype
        if tokens.shape[0] != cache["k"].shape[1]:
            tokens = self.place.take(tokens)
        b = tokens.shape[0]
        mesh = self.place.decode_mesh(cache)
        x = self._positions(_embed(params, tokens, cfg, dtype)[:, None, :], pos)
        for i, lp in enumerate(params["layers"]):
            h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
            q, k, v = qkv_proj(lp["attn"], h, cfg, dtype)
            a, _, _ = serve_attention.decode_attention(q, cache["k"][i], cache["v"][i], k, v,
                                                       pos, mesh=mesh)
            x = x + a.reshape(b, 1, -1) @ lp["attn"]["wo"].to(dtype)
            h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
            q = (h @ lp["xattn"]["wq"].to(dtype)).reshape(b, 1, cfg.n_heads, cfg.head_dim)
            a = dispatch_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                                   impl=self.plan.attn_impl, causal=False)
            x = x + a.reshape(b, 1, -1) @ lp["xattn"]["wo"].to(dtype)
            h = rms_norm(x, lp["norm3"]["scale"], cfg.rms_eps)
            x = x + mlp_block(lp["mlp"], h, dtype)
        return self._head(params, x[:, 0, :]), cache


def build_model(cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                device=None, mesh=None, batch_axes=None):
    """Dense, MoE, VLM, SSM, hybrid and encoder-decoder models; ``device``
    defaults to the CUDA card. ``mesh`` (a data mesh or a grid) places the
    serving entry points and ZeRO-3's gather (module docstring);
    ``batch_axes`` None follows the reference's rule per batch, () serves
    every row on every rank."""
    if plan is not None:
        plan.validate(cfg)
    kw = dict(device=device, mesh=mesh, batch_axes=batch_axes)
    if cfg.is_enc_dec:
        return EncDecModel(cfg, plan, **kw)
    if cfg.family == Family.SSM:
        return SSMModel(cfg, plan, **kw)
    if cfg.family == Family.HYBRID:
        return HybridModel(cfg, plan, **kw)
    return Model(cfg, plan, **kw)
