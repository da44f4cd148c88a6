"""Model configuration and architecture registry (the port's own copy).

Mirrors ``repro/configs/base.py`` field for field for the parts the serving
path, the controller and the train step read, so a test can build the same
config in both packages: model configs, input shapes (``ShapeConfig``) and
pipeline plans (``PipelinePlan``).  The registry's per-shape default plans
are not part of the port yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

MIXER_ATTN = "attn"          # self attention (GQA / MHA)
MIXER_MLA = "mla"            # DeepSeek-V2 multi-head latent attention
MIXER_MAMBA = "mamba"        # Mamba-1 selective SSM
MIXER_RWKV = "rwkv"          # RWKV-6 (Finch) time mix
MIXER_CROSS = "cross"        # cross-attention

MLP_DENSE = "dense"
MLP_MOE = "moe"


@dataclass(frozen=True)
class LayerKind:
    """Static description of one layer position inside the repeating pattern."""
    mixer: str = MIXER_ATTN
    mlp: str = MLP_DENSE
    extra_cross: bool = False


@dataclass(frozen=True)
class MoEConfig:
    """Top-k routed experts (GShard-style capacity), plus always-on shared
    experts.  ``router_jitter`` is carried as the reference carries it: its
    ``apply_moe`` does not read it."""
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert hidden dim
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention: the query and key/value
    low-rank widths and the per-head split of q/k into a position-free
    (``nope``) part and a rotary part shared by every head."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 and RWKV-6 sizes."""
    # mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model/16)
    # rwkv6
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    sliding_window: int = 0
    global_every: int = 0
    pattern: tuple[LayerKind, ...] = (LayerKind(),)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0
    n_memory_tokens: int = 0
    mlp_act: str = "swiglu"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_size(self) -> int:
        return len(self.pattern)

    @property
    def n_patterns(self) -> int:
        """Repeats of the layer pattern (the controller's stage unit)."""
        if self.n_layers % self.pattern_size:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern_size={self.pattern_size}")
        return self.n_layers // self.pattern_size

    def layer_kind(self, layer_idx: int) -> LayerKind:
        return self.pattern[layer_idx % self.pattern_size]

    def is_global_layer(self, layer_idx: int) -> bool:
        """Every ``global_every``-th layer is global (gemma3-style), counted
        by the layer's position within the repeating pattern."""
        if not self.global_every:
            return True
        j = layer_idx % self.pattern_size if self.pattern_size > 1 else layer_idx
        return (j % self.global_every) == (self.global_every - 1)

    def param_count(self) -> int:
        """Exact parameter count (embedding + blocks + head)."""
        from repro_torch.models.transformer import count_params
        return count_params(self)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Parallelism plan: FlexPipe's granularity knob
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PipelinePlan:
    """Factorization of the mesh axes for one pipeline configuration.

    The production mesh's model axis (16) factorizes into
    ``stages * tensor * replica``; FlexPipe refactoring moves between plans.
    """
    stages: int = 1               # pipeline stages S (the paper's granularity)
    tensor: int = 1               # tensor parallelism T inside each stage
    replica: int = 1              # extra model-axis replicas R (serving DP)
    microbatches: int = 1         # GPipe microbatch count M
    # decode-time sequence parallelism: shard the KV cache over the data axis
    # (flash-decode across devices), used for long_500k
    seq_parallel_kv: bool = False
    remat: bool = True            # activation checkpointing for training
    # ZeRO-3/FSDP: params (and optimizer moments) additionally sharded over
    # the data axis, all-gathered per layer inside the stage
    fsdp: bool = False
    # cast FSDP all-gathers to fp8
    fsdp_fp8_gather: bool = False
    # KV cache dtype: "bf16" | "fp8"
    kv_dtype: str = "bf16"

    @property
    def model_axis(self) -> int:
        return self.stages * self.tensor * self.replica

    def validate(self, cfg: ModelConfig, model_axis: int = 16) -> None:
        if self.model_axis != model_axis:
            raise ValueError(
                f"plan S*T*R={self.model_axis} != model axis {model_axis}")
        if cfg.n_patterns % self.stages != 0:
            raise ValueError(
                f"{cfg.name}: {cfg.n_patterns} patterns not divisible by "
                f"S={self.stages} (pattern boundary constraint, DESIGN.md §5)")
        # non-divisible head/ff dims degrade to replication in sharding
        if cfg.vocab_size % (self.stages * self.tensor):
            raise ValueError(
                f"{cfg.name}: vocab {cfg.vocab_size} not divisible by "
                f"S*T={self.stages * self.tensor} (vocab-parallel embed/head)")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    smoke_config: ModelConfig
    default_plans: dict[str, PipelinePlan]          # shape name -> plan
    skip_shapes: tuple[str, ...] = ()     # e.g. long_500k for full attention

    def plan_for(self, shape: str) -> PipelinePlan:
        return self.default_plans[shape]


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.config.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)} "
                       "(other architectures are still to be ported, see "
                       "ROADMAP.md)")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from repro_torch.configs import deepseek_moe_16b  # noqa: F401 (registers)
    from repro_torch.configs import deepseek_v2_236b  # noqa: F401
    from repro_torch.configs import gemma3_1b  # noqa: F401
    from repro_torch.configs import gemma3_12b  # noqa: F401
    from repro_torch.configs import jamba_v0_1_52b  # noqa: F401
    from repro_torch.configs import llama3_2_vision_11b  # noqa: F401
    from repro_torch.configs import qwen1_5_0_5b  # noqa: F401
    from repro_torch.configs import qwen1_5_110b  # noqa: F401
    from repro_torch.configs import rwkv6_1_6b  # noqa: F401
    from repro_torch.configs import whisper_tiny  # noqa: F401


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build a reduced same-family config for smoke tests."""
    return dataclasses.replace(cfg, **overrides)
