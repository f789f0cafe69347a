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
keeps them whole on every rank. Without a mesh it changes nothing.

``ParallelPlan.dp_shard`` is the reference's ZeRO-3 / FSDP switch (survey
§4.1.1): any value above 1 splits the params themselves over the whole data
domain, each leaf on the largest dim the domain's size divides
(``repro_torch.core.sharding.fsdp_specs``), and the moments on the same slice;
every layer gathers its params inside its remat boundary and its backward
reduce-scatters the grads (``repro_torch.train.fsdp``). The reference's
executor refuses it with tp, cp or ep, and so does the port; the port also
refuses it with pp (its pipeline takes each stage's params whole).

``ParallelPlan.dp_over_model`` is the reference's remap of a grid's model axis
to more data parallelism: the batch and the data domain cover the data x model
ranks (``repro_torch.launch.mesh.data_mesh``, ``batch_axes_for``) and no leaf
splits on ``model``. It refuses cp > 1 and ep > 1, as the reference does.

``ParallelPlan.seq_shard_decode`` and ``seq_shard_attn`` are the reference's
serving placement on a grid: the decode cache's sequence dim over the model
ranks (``repro_torch.serve.attention.decode_attention``'s sharded branch) and
the prefill's queries over them, K/V gathered whole
(``repro_torch.models.families``).

``ParallelPlan.tp`` and ``tp_impl`` are the reference's tensor-parallel
degree and mode (survey §4.1.2): ``tp`` > 1 on a (data, model) grid
(``repro_torch.launch.mesh.GridMesh``) runs the overlap rings of
``repro_torch.train.tensor_parallel``. ``tp_impl`` reads differently: ``"auto"``
and ``"overlap"`` both run the rings (the reference resolves ``"auto"`` to
``"gspmd"`` off the TPU); ``"gspmd"`` raises ``NotImplementedError``, since the
port has no XLA partitioner to lay the model out (ROADMAP queue A).

``ParallelPlan.cp`` and ``cp_impl`` are the reference's context-parallel degree
and mode (survey §4.1.4): ``cp`` > 1 on a grid with a cp axis of that size
(``init_grid_mesh(cp=)``) shards the sequence over the cp ranks end to end
(``repro_torch.train.executor``): ring attention with zigzag ownership
(``"ring"``) or K/V all-gathered over contiguous chunks (``"gather"``), the
Mamba2 conv halo and entering-state chain, MoE routed on the local tokens with
the aux statistics summed over the ranks. ``"auto"`` takes the ring where it
can (``repro_torch.kernels.dispatch.select_cp_impl``).

``ParallelPlan.ep`` and ``ep_impl`` are the reference's expert-parallel degree
and mode (survey §4.1.5): ``ep`` > 1 shards the routed experts over the
*folded* cp × model ranks of a grid (MoE parallel folding): with cp or tp on,
``ep`` must equal cp × tp; with neither (the ep-only placement) the experts
ride the model axis and attention runs as a cp ring over it. ``ep_impl``
picks the token exchange: ``"blocking"`` (one all-to-all before the experts
and one after) or ``"overlap"`` (ring ticks with the expert GEMMs between
them); ``"auto"`` is ``"overlap"``
(``repro_torch.kernels.dispatch.select_ep_impl``).

``ParallelPlan.pp``, ``pp_layout`` and ``pp_schedule`` are the reference's
pipeline degree, layers per stage and schedule (survey §4.1.3): ``pp`` > 1 on
a grid with a pod axis of that size (``init_grid_mesh(pod=)``) holds stage p's
layers on the ranks of pod index p and runs ``repro_torch.train.pipeline``'s
``pipelined_loss_fn`` (``"gpipe"``: autograd through the fill-drain ticks;
``"1f1b"``, the default: a custom backward that interleaves the drain with
the forward recompute). ``pp_layout`` is an uneven split (each stage >= 1
layer, summing to ``n_layers``); without it ``pp`` must divide ``n_layers``.
The single-device train step refuses ``pp`` > 1 (``train.step``).

``ParallelPlan.integrity`` (``"off"`` | ``"audit"``) is the reference's
silent-data-corruption audit: under ``"audit"`` the train step's metrics gain
``integrity_checksum`` and ``integrity_div`` (``repro_torch.ft.integrity``).

``RecoveryPolicy`` is the reference's anomaly -> action table for
``repro_torch.ft.recovery.run_with_recovery``, with the same fields, defaults
and ``validate()``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

from .device import resolve_dtype

ATTN_IMPLS = ("auto", "plain", "cuda")    # also the choices of moe_gemm_impl, ssm_impl
MOE_DISPATCH_MODES = ("einsum", "scatter")
REMAT_MODES = ("none", "full", "selective")
ZERO_STAGES = (0, 1)
INTEGRITY_MODES = ("off", "audit")
TP_IMPLS = ("auto", "gspmd", "overlap")
CP_IMPLS = ("auto", "gather", "ring")
EP_IMPLS = ("auto", "blocking", "overlap")
PP_SCHEDULES = ("gpipe", "1f1b")


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


def check_tp_impl(impl: str) -> None:
    """Refuse a ``tp_impl`` the port cannot run (module docstring)."""
    if impl not in TP_IMPLS:
        raise ValueError(f"tp_impl must be one of {TP_IMPLS}, got {impl!r}")
    if impl == "gspmd":
        raise NotImplementedError(
            "tp_impl='gspmd': the port has no XLA partitioner to lay tensor "
            "parallelism out; 'auto' and 'overlap' run the rings (ROADMAP queue A, "
            "a blocking TP path)")


def warn_shard_local_routing(cfg: ModelConfig) -> None:
    """The reference's warning: under shard-local MoE routing (the ring
    paths) a token-dropping capacity drops per shard, which may differ from
    routing over the whole batch. No-op for other families and for a
    capacity that drops nothing (``capacity_factor * top_k >= E``)."""
    if cfg.moe is None or cfg.moe.capacity_factor * cfg.moe.top_k >= cfg.moe.num_experts:
        return
    warnings.warn(
        "token-dropping capacity under shard-local MoE routing "
        f"(capacity_factor={cfg.moe.capacity_factor} < "
        f"E/top_k={cfg.moe.num_experts / cfg.moe.top_k:g}): drop decisions "
        "are per data/context shard and may diverge from the global-routing "
        "baseline; use capacity_factor >= E/top_k for exact equivalence",
        UserWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The reference's plan: the same fields, names and defaults (module
    docstring for the knobs that read differently here)."""
    tp: int = 1                    # tensor-parallel degree: the grid's model axis
    tp_impl: str = "auto"          # "auto" | "overlap": the rings of
                                   # train/tensor_parallel.py; "gspmd" raises
                                   # (module docstring)
    cp: int = 1                    # context-parallel degree: the grid's cp axis
                                   # (the sequence sharded end to end)
    cp_impl: str = "auto"          # "auto" | "gather" | "ring" (module docstring)
    ep: int = 1                    # expert-parallel degree: the routed experts over
                                   # the folded cp x model ranks (module docstring)
    ep_impl: str = "auto"          # "auto" | "blocking" | "overlap" (module docstring)
    pp: int = 1                    # pipeline stages over the grid's pod axis
    pp_layout: Optional[Tuple[int, ...]] = None
                                   # layers per stage (uneven, Malleus-style; each
                                   # >= 1, summing to n_layers); None: the even split
    pp_schedule: str = "1f1b"      # "gpipe" | "1f1b" (module docstring)
    microbatches: int = 1          # grad-accumulation / pipeline microbatches
    remat: str = "full"            # "none" | "full" | "selective", per decoder
                                   # or Mamba2 layer (train/executor.py)
    seq_shard_decode: bool = True  # the decode cache's sequence dim over the
                                   # grid's model ranks
    seq_shard_attn: bool = True    # the prefill's queries over the model ranks,
                                   # K/V gathered whole (module docstring)
    pad_vocab_to_multiple: int = 0 # padded logits are masked to -1e9
    dp_over_model: bool = False    # the grid's model axis as more data
                                   # parallelism (module docstring)
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
    dp_shard: int = 1              # > 1: ZeRO-3 / FSDP, the params split over the
                                   # data domain (module docstring)
    zero_stage: int = 1            # 0: moments whole on every data rank, 1: sharded
                                   # over the data ranks (ZeRO-1; module docstring)
    integrity: str = "off"         # "off" | "audit": the step's exact uint32
                                   # checksum of the new params and clipped grads,
                                   # cross-checked over the data ranks
                                   # (ft/integrity.py; module docstring)

    def __post_init__(self):
        if self.pp_layout is not None:
            # a tuple of ints, so the frozen plan stays hashable and a layout
            # read back from JSON ([3, 1]) compares equal
            object.__setattr__(self, "pp_layout", tuple(int(x) for x in self.pp_layout))

    def validate(self, cfg: ModelConfig) -> None:
        if self.integrity not in INTEGRITY_MODES:
            raise ValueError(
                f"integrity must be off|audit, got {self.integrity!r}")
        for knob in ("attn_impl", "moe_gemm_impl", "ssm_impl"):
            if getattr(self, knob) not in ATTN_IMPLS:
                raise ValueError(f"{knob} must be one of {ATTN_IMPLS}, "
                                 f"got {getattr(self, knob)!r}")
        if not isinstance(self.tp, int) or self.tp < 1:
            raise ValueError(f"tp must be an int >= 1, got {self.tp!r}")
        if self.cp_impl not in CP_IMPLS:
            raise ValueError(f"cp_impl must be one of {CP_IMPLS}, got {self.cp_impl!r}")
        if not isinstance(self.cp, int) or self.cp < 1:
            raise ValueError(f"cp must be >= 1, got {self.cp!r}")
        if self.cp > 1:
            if cfg.family not in (Family.DENSE, Family.MOE, Family.SSM):
                raise ValueError(f"cp > 1 supports dense/moe/ssm decoder-only families "
                                 f"(the executor's wiring), got {cfg.family!r}")
            if self.tp > 1 and self.tp_impl == "gspmd":
                raise ValueError("cp > 1 composes with tp through the rings; set "
                                 "tp_impl='overlap' (or 'auto')")
            if self.dp_over_model:
                raise ValueError("cp > 1 is incompatible with dp_over_model")
        check_tp_impl(self.tp_impl)
        if self.ep_impl not in EP_IMPLS:
            raise ValueError(f"ep_impl must be one of {EP_IMPLS}, got {self.ep_impl!r}")
        if isinstance(self.ep, bool) or not isinstance(self.ep, int):
            raise ValueError(
                "ParallelPlan.ep is an integer expert-parallel degree (the reference's "
                f"legacy bool selected a GSPMD path the port does not have); got "
                f"ep={self.ep!r} — use ep=<degree>")
        if self.ep < 1:
            raise ValueError(f"ep must be >= 1, got {self.ep}")
        # shard-local routing drops per shard under a token-dropping capacity
        # (the reference's documented divergence; exact when nothing drops)
        if self.cp > 1 or self.tp > 1 or self.ep > 1:
            warn_shard_local_routing(cfg)
        if self.ep > 1:
            if cfg.family != Family.MOE:
                raise ValueError(f"expert parallelism requires a MoE arch, got {cfg.family}")
            if self.dp_over_model:
                raise ValueError("dp_over_model consumes the model axis; EP needs it")
            # MoE parallel folding: the expert ring re-reads the cp x model
            # ranks, so its size is theirs; the ep-only placement (tp == cp
            # == 1) is checked against the grid by executor.resolve_context
            fold = self.cp * self.tp
            if fold > 1 and self.ep != fold:
                raise ValueError(
                    f"ep={self.ep} must equal cp×tp={fold}: the expert axis folds onto "
                    "the existing cp/model ring (MoE parallel folding), a re-mapping of "
                    "those ranks, not extra ones")
            if cfg.moe.num_experts % self.ep:
                raise ValueError(f"ep={self.ep} must divide num_experts="
                                 f"{cfg.moe.num_experts} for expert parallelism")
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
        self._validate_pp(cfg)
        self._validate_fsdp()

    def _validate_fsdp(self) -> None:
        """ZeRO-3 runs with data parallelism alone (with or without the
        ``dp_over_model`` remap): the reference's executor loss refuses
        ``dp_shard`` > 1 with tp, cp or ep, and the port's pipeline takes
        each stage's params whole (ROADMAP queue C)."""
        if not isinstance(self.dp_shard, int) or self.dp_shard < 1:
            raise ValueError(f"dp_shard must be an int >= 1, got {self.dp_shard!r}")
        if self.dp_shard > 1:
            for knob in ("tp", "cp", "ep", "pp"):
                if getattr(self, knob) > 1:
                    raise ValueError(
                        f"dp_shard={self.dp_shard} (ZeRO-3) runs with data parallelism "
                        f"alone, got {knob}={getattr(self, knob)}: the executor loss "
                        f"expects dp_shard == 1 under tp, cp and ep, and the pipeline "
                        f"takes each stage's params whole")
        if self.dp_over_model and self.tp > 1:
            raise ValueError(f"dp_over_model runs the model axis as data parallelism; "
                             f"tp={self.tp} needs it")

    def _validate_pp(self, cfg: ModelConfig) -> None:
        """The reference's pipeline checks, and ``microbatches >= pp`` (its
        ``pipelined_loss_fn`` asserts it)."""
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError(f"pp_schedule must be one of {PP_SCHEDULES}, "
                             f"got {self.pp_schedule!r}")
        if not isinstance(self.pp, int) or self.pp < 1:
            raise ValueError(f"pp must be an int >= 1, got {self.pp!r}")
        if self.pp_layout is not None:
            if self.pp <= 1:
                raise ValueError(f"pp_layout requires pp > 1, got pp={self.pp}")
            if len(self.pp_layout) != self.pp:
                raise ValueError(f"pp_layout length {len(self.pp_layout)} != pp={self.pp}")
            if any(x < 1 for x in self.pp_layout):
                raise ValueError(f"pp_layout stages need >= 1 layer, got {self.pp_layout}")
            if sum(self.pp_layout) != cfg.n_layers:
                raise ValueError(f"pp_layout {self.pp_layout} sums to {sum(self.pp_layout)}, "
                                 f"expected n_layers={cfg.n_layers}")
        elif self.pp > 1 and cfg.n_layers % self.pp:
            raise ValueError(f"n_layers={cfg.n_layers} must divide pp={self.pp} (or give an "
                             "explicit pp_layout)")
        if self.pp > 1 and self.microbatches < self.pp:
            raise ValueError(f"pipelining needs microbatches >= pp, got microbatches="
                             f"{self.microbatches} < pp={self.pp}")


# ---------------------------------------------------------------------------
# Recovery policy (survey §8): what ft/recovery.run_with_recovery does per
# anomaly kind reported by ft/anomaly.Monitor (the reference's table; see its
# ``RecoveryPolicy`` for each action's full description).

RECOVERY_ACTIONS = ("rollback", "lr_rescue", "remesh", "rebalance", "ignore")


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Anomaly -> action table for the recovery driver (survey §8.3).
    ``"rollback"`` restores the latest intact checkpoint and replays;
    ``"lr_rescue"`` rolls back and runs the bad step with the driver's
    ``rescue_step`` (or skips its batch); ``"remesh"`` rebuilds the world
    through the driver's ``remesh`` hook and reshard-restores;
    ``"rebalance"`` re-partitions a pipeline's layers (needs a pipeline,
    which the port's plan does not have yet, so it degrades as in the
    reference); ``"ignore"`` logs and goes on."""
    nan: str = "rollback"            # non-finite loss or grad norm
    spike: str = "rollback"          # first loss spike at a step
    repeated_spike: str = "lr_rescue"  # the same step spikes again after a rollback
    hang: str = "ignore"             # slow or hung step (watchdog advisory by default)
    sdc: str = "rollback"            # integrity-checksum divergence over the ranks
    straggler: str = "ignore"        # fail-slow attribution (ft/straggler.py)
    ckpt_io: str = "ignore"          # a persist that failed after its retries
    max_restores: int = 3            # give up after this many restores
    rescue_lr_scale: float = 0.1     # LR multiplier of an lr_rescue step
    elastic: bool = True             # check_plan may route "reshard"
    ckpt_memory_keep: int = 2        # RAM tier: snapshots kept (0 disables)
    peer_redundancy: bool = True     # RAM tier: mirror each group (False refused)
    preempt_grace: float = 30.0      # seconds between a preemption notice and the kill
    flight_len: int = 256            # flight recorder ring capacity (events)
    straggler_factor: float = 2.0    # slow when above factor x the baseline
    straggler_window: int = 16       # observations kept per (section, rank)
    straggler_confirm: int = 3       # consecutive slow observations to confirm
    straggler_min_seconds: float = 5e-3   # absolute slowdown floor (seconds)

    def validate(self) -> None:
        for knob in ("nan", "spike", "repeated_spike", "hang", "sdc",
                     "ckpt_io", "straggler"):
            if getattr(self, knob) not in RECOVERY_ACTIONS:
                raise ValueError(
                    f"{knob} action must be one of {RECOVERY_ACTIONS}, "
                    f"got {getattr(self, knob)!r}")
        if self.max_restores < 0:
            raise ValueError(f"max_restores must be >= 0, got {self.max_restores}")
        if not 0.0 < self.rescue_lr_scale <= 1.0:
            raise ValueError(
                f"rescue_lr_scale must be in (0, 1], got {self.rescue_lr_scale}")
        if self.ckpt_memory_keep < 0:
            raise ValueError(
                f"ckpt_memory_keep must be >= 0, got {self.ckpt_memory_keep}")
        if not self.peer_redundancy:
            raise ValueError(
                "peer_redundancy=False: the port's RAM tier always mirrors each "
                "group on its neighbour (ROADMAP A12)")
        if self.preempt_grace <= 0.0:
            raise ValueError(
                f"preempt_grace must be > 0, got {self.preempt_grace}")
        if self.flight_len < 1:
            raise ValueError(
                f"flight_len must be >= 1, got {self.flight_len}")
        if self.straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {self.straggler_factor}")
        if self.straggler_window < 4:
            raise ValueError(
                f"straggler_window must be >= 4, got {self.straggler_window}")
        if self.straggler_confirm < 1:
            raise ValueError(
                f"straggler_confirm must be >= 1, got {self.straggler_confirm}")
        if self.straggler_min_seconds < 0.0:
            raise ValueError(
                f"straggler_min_seconds must be >= 0, "
                f"got {self.straggler_min_seconds}")


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
