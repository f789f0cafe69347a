"""Configuration: the port's own copy of ``repro/core/config.py``.

The same frozen dataclasses and field names, so a configuration reads the same
in both packages (see the reference for each knob's full description).
``ParallelPlan`` holds only the knobs the port implements so far. One knob reads
differently here, because the port has different implementations:

``ParallelPlan.attn_impl``: ``"auto"`` | ``"plain"`` | ``"cuda"``.
    ``"auto"`` runs the hand-written CUDA kernel on a CUDA tensor and the plain
    PyTorch attention on a CPU tensor; ``"plain"`` forces the plain PyTorch
    attention; ``"cuda"`` forces the kernel (a CPU tensor raises). Resolved
    per call site by ``repro_torch.kernels.dispatch.select_impl``.

``ParallelPlan.moe_gemm_impl`` reads the same way for the MoE expert GEMMs
(the reference's ``"xla"`` is ``"plain"`` here, its ``"pallas"`` ``"cuda"``),
resolved by ``repro_torch.kernels.dispatch.select_gemm_impl``, and
``ParallelPlan.ssm_impl`` for the Mamba2 SSD chunk scan, resolved by
``repro_torch.kernels.dispatch.select_ssd_impl``.

``ParallelPlan.param_dtype`` is read here, where the reference declares it but
always keeps fp32: ``Model.init`` holds matrices, biases and embeddings in it
(an SSM block's ``dt_bias``, ``A_log``, ``D`` and norm scale stay fp32).

``ParallelPlan.zero_stage`` (0 or 1) is the reference's: under a data mesh
(``repro_torch.launch.mesh.DataMesh``) stage 1 shards the AdamW moments over
the data ranks (ZeRO-1, ``repro_torch.core.sharding.opt_state_specs``), stage 0
keeps them whole on every rank. Without a mesh it changes nothing. The
reference's ZeRO-3 ``dp_shard`` is not here (ROADMAP A13.7).

``RecoveryPolicy`` waits for the fault-tolerance slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .device import resolve_dtype

ATTN_IMPLS = ("auto", "plain", "cuda")    # also the choices of moe_gemm_impl, ssm_impl
MOE_DISPATCH_MODES = ("einsum", "scatter")
REMAT_MODES = ("none", "full", "selective")
ZERO_STAGES = (0, 1)


class Family:
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    AUDIO = "audio"   # encoder-decoder with audio-frame frontend stub
    VLM = "vlm"       # decoder with vision-patch frontend stub


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size (fine-grained MoE)
    num_shared_experts: int = 0   # DeepSeek-MoE style always-on experts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    pos_emb: str = "rope"         # "rope" | "sinusoidal" (whisper)
    rope_theta: float = 1e4
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    # gemma2-style features
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0       # 0 -> full attention
    local_global_alternating: bool = False  # even layers local (sliding), odd global
    long_context: bool = False    # beyond-paper: force all layers sliding-window
    post_norm: bool = False       # gemma2 post-sub-block RMSNorms
    scale_embed: bool = False     # gemma: embeddings scaled by sqrt(d_model)

    # family extras
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): apply a weight-shared attention block every k ssm layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500        # audio frontend stub: frame-embedding count

    # vlm (pixtral)
    vision_tokens: int = 0        # patch-embedding count supplied by frontend stub

    # citation: source paper / model card for this config
    source: str = ""

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_enc_dec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == Family.SSM

    @property
    def sub_quadratic(self) -> bool:
        if self.family in (Family.SSM, Family.HYBRID):
            return True
        return bool(self.sliding_window) and self.long_context

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.head_dim
        total = V * d                       # embedding
        if not self.tie_embeddings:
            total += V * d                  # lm head

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + b

        def mlp_params(dff: int) -> int:
            return 3 * d * dff              # SwiGLU: gate, up, down

        def ssm_params() -> int:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            ng, ns = self.ssm.n_groups, self.ssm.d_state
            in_proj = d * (2 * di + 2 * ng * ns + nh)
            conv = (di + 2 * ng * ns) * self.ssm.d_conv
            out = di * d
            return in_proj + conv + out + 2 * nh  # + A_log, D

        if self.family == Family.SSM:
            total += L * (ssm_params() + d)
        elif self.family == Family.HYBRID:
            total += L * (ssm_params() + d)
            if self.shared_attn_every:
                total += attn_params() + 2 * d  # one shared block
        elif self.family == Family.MOE:
            per_layer = attn_params() + 2 * d
            e = self.moe
            per_layer += d * e.num_experts                       # router
            per_layer += e.num_experts * 3 * d * e.d_expert      # routed experts
            per_layer += e.num_shared_experts * 3 * d * e.d_expert
            total += L * per_layer
        else:  # dense / vlm decoder / audio
            total += L * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            if self.is_enc_dec:
                total += self.enc_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
                total += L * (attn_params() + d)
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k + shared experts)."""
        if self.family != Family.MOE:
            return self.param_count()
        e = self.moe
        d, L = self.d_model, self.n_layers
        inactive = L * (e.num_experts - e.top_k) * 3 * d * e.d_expert
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The reference's plan, cut to the knobs the port reads (same names and
    defaults). The reference's other parallel axes (tp, cp, pp, ep, dp_shard)
    come with the slices that implement them, so a plan cannot ask for a
    placement the port would quietly ignore."""
    microbatches: int = 1          # grad-accumulation microbatches
    remat: str = "full"            # "none" | "full" | "selective", per decoder
                                   # or Mamba2 layer (train/executor.py)
    pad_vocab_to_multiple: int = 0 # padded logits are masked to -1e9
    moe_dispatch: str = "einsum"   # "einsum": GShard one-hot dispatch/combine;
                                   # "scatter": index gather/scatter, the same
                                   # routing (models/moe.py)
    attn_impl: str = "auto"        # "auto" | "plain" | "cuda" (module docstring)
    moe_gemm_impl: str = "auto"    # the same choices, for the three expert GEMMs
                                   # of every MoE layer (module docstring)
    ssm_impl: str = "auto"         # the same choices, for the SSD chunk scan of
                                   # every Mamba2 layer (module docstring)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"   # matrices, biases and embeddings as held by
                                   # ``Model.init``; norm scales stay fp32. The
                                   # reference always keeps fp32 masters; a
                                   # serving run asks for the compute dtype
                                   # (the same bits, half the memory).
    zero_stage: int = 1            # 0: moments whole on every data rank, 1: sharded
                                   # over the data ranks (ZeRO-1; module docstring)

    def validate(self, cfg: ModelConfig) -> None:
        for knob in ("attn_impl", "moe_gemm_impl", "ssm_impl"):
            if getattr(self, knob) not in ATTN_IMPLS:
                raise ValueError(f"{knob} must be one of {ATTN_IMPLS}, "
                                 f"got {getattr(self, knob)!r}")
        if self.moe_dispatch not in MOE_DISPATCH_MODES:
            raise ValueError(f"moe_dispatch must be one of {MOE_DISPATCH_MODES}, "
                             f"got {self.moe_dispatch!r}")
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"remat must be one of {REMAT_MODES}, got {self.remat!r}")
        if not isinstance(self.microbatches, int) or self.microbatches < 1:
            raise ValueError(f"microbatches must be an int >= 1, "
                             f"got {self.microbatches!r}")
        if self.zero_stage not in ZERO_STAGES:
            raise ValueError(f"zero_stage must be one of {ZERO_STAGES}, "
                             f"got {self.zero_stage!r}")
        resolve_dtype(self.compute_dtype)            # raises on an unknown name
        resolve_dtype(self.param_dtype)
        if self.pad_vocab_to_multiple < 0:
            raise ValueError(f"pad_vocab_to_multiple must be >= 0, "
                             f"got {self.pad_vocab_to_multiple}")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}
