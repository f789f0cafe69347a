"""Model assembly: the dense decoder and its MoE and VLM variants (port of
``repro/models/families.py``).

``build_model`` returns a :class:`Model` with the reference's API:

- ``init(gen) -> params``
- ``forward(params, batch) -> (logits, aux)``            (parallel pass)
- ``init_cache(batch, max_seq) -> cache``                 (zeros)
- ``prefill(params, batch, max_seq) -> (logits, cache)``  (prompt + KV cache)
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
are held like the other matrices. SSM, hybrid and encoder-decoder families come
with their own slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.config import Family, ModelConfig, ParallelPlan
from repro_torch.core.device import resolve_device, resolve_dtype
from repro_torch.core.tree import map_tree
from repro_torch.serve.attention import decode_attention
from .layers import (dense_init, init_attn, init_mlp, mlp_block, qkv_proj,
                     rms_norm, rope, sinusoidal_pos_emb)
from .moe import init_moe, moe_block


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


def _embed(params, tokens, cfg: ModelConfig, dtype):
    x = params["embed"]["tok"][tokens].to(dtype)
    if cfg.scale_embed:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
    return x


def _init_decoder_layer(cfg: ModelConfig, gen: torch.Generator, dtype):
    """One layer's params: matrices and biases in ``dtype``, norm scales fp32.
    Drawn in fp32 and cast one layer at a time, so fp32 copies of the whole
    model never coexist with the compute-dtype copy."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32,  # noqa: E731
                                device=gen.device)
    p = {
        "norm1": {"scale": zeros()},
        "norm2": {"scale": zeros()},
        "attn": {k: w.to(dtype) for k, w in init_attn(gen, cfg).items()},
    }
    if cfg.post_norm:
        p["norm1_post"] = {"scale": zeros()}
        p["norm2_post"] = {"scale": zeros()}
    if cfg.family == Family.MOE:
        p["moe"] = map_tree(lambda w: w.to(dtype), init_moe(gen, cfg))
    else:
        p["mlp"] = {k: w.to(dtype) for k, w in
                    init_mlp(gen, cfg.d_model, cfg.d_ff).items()}
    return p


class Model:
    """The dense / MoE / VLM decoder on one device (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                 device=None):
        from repro_torch.train import executor as exlib  # noqa: PLC0415 (import cycle)
        self.cfg = cfg
        self.plan = plan or ParallelPlan()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(self.plan.compute_dtype)
        self.param_dtype = resolve_dtype(self.plan.param_dtype)
        self.windows = _layer_windows(cfg)
        self._layer = exlib.decoder_layer(cfg, self.plan, self.dtype)
        self._layer_kv = exlib.decoder_layer(cfg, self.plan, self.dtype,
                                             collect_kv=True)

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
            "final_norm": {"scale": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                                device=gen.device)},
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
        x = _embed(params, tokens, cfg, dtype)
        if cfg.family == Family.VLM and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(dtype)            # (B, N_img, d)
            vp = batch["vision_pos"]                         # (B, N_img)
            x[torch.arange(b, device=x.device)[:, None], vp] = ve
        positions = torch.arange(s, device=x.device)
        if cfg.pos_emb == "sinusoidal":
            x = x + sinusoidal_pos_emb(positions, cfg.d_model).to(dtype)
        return x, positions

    def _head(self, params, x):
        x = rms_norm(x, params["final_norm"]["scale"], self.cfg.rms_eps)
        return _logits(params, x, self.cfg, self.dtype)

    # -- entry points -------------------------------------------------------

    def forward(self, params, batch):
        x, positions = self._inputs(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, w in zip(params["layers"], self.windows):
            x, a = self._layer(x, lp, w, positions)
            aux = aux + a
        return self._head(params, x), aux

    def init_cache(self, batch: int, max_seq: int):
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, params, batch, max_seq: int):
        """Process a prompt in parallel and return (logits, filled cache).

        The serving flow: prefill once (full forward, KV emitted per layer) then
        call decode_step from position S onward. Serving records no autograd
        graph, so ``plan.remat`` does not apply here.
        """
        b, s = batch["tokens"].shape
        if s > max_seq:
            raise ValueError(f"prompt length {s} exceeds max_seq {max_seq}")
        x, positions = self._inputs(params, batch)
        cache = self.init_cache(b, max_seq)
        for i, (lp, w) in enumerate(zip(params["layers"], self.windows)):
            x, _, (k, v) = self._layer_kv(x, lp, w, positions)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        return self._head(params, x), cache

    def decode_step(self, params, cache, tokens, pos: int):
        """One token per sequence at position ``pos``; writes the cache in place."""
        cfg, dtype = self.cfg, self.dtype
        b = tokens.shape[0]
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
            a, _, _ = decode_attention(q, cache["k"][i], cache["v"][i], k, v, pos,
                                       window=w, softcap=cfg.attn_logit_softcap)
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


_LATER = {
    Family.SSM: "the Mamba2 slice",
    Family.HYBRID: "the Mamba2/hybrid slice",
}


def build_model(cfg: ModelConfig, plan: Optional[ParallelPlan] = None, *,
                device=None) -> Model:
    """Dense, MoE and VLM decoders; ``device`` defaults to the CUDA card."""
    if plan is not None:
        plan.validate(cfg)
    if cfg.is_enc_dec:
        raise NotImplementedError(
            f"{cfg.arch_id}: encoder-decoder models come with the port's "
            "encoder-decoder slice")
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family comes with {_LATER[cfg.family]}")
    return Model(cfg, plan, device=device)
