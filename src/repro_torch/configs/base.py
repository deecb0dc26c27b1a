"""Config dataclasses + registry for the assigned architectures: the
port's copy of ``repro.configs.base``, field for field.

A model is assembled from a repeating ``layer_pattern`` of (token-mixer,
channel-mixer) pairs; its parameters are stacked by layer group (one group
= one period of the pattern):

  mixers:   "attn" (GQA/MHA, optional qk_norm/bias), "mla", "mamba", "rwkv"
  channels: "mlp" (swiglu/gelu), "moe", "rwkv_ffn"

Shapes (assigned): each cell names a step kind —
  train_4k / prefill_32k run train_step / prefill_step;
  decode_32k / long_500k run serve_step (1 new token, KV cache of seq_len).

``repro_torch.models`` builds, serves and trains every mixer and
channel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str          # "attn" | "mla" | "mamba" | "rwkv"
    channel: str        # "mlp" | "moe" | "rwkv_ffn"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | ssm | vlm | moe | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "mlp"),)

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    parallel_block: bool = False     # command-r style parallel attn+mlp
    pos_embed: str = "rope"          # "rope" | "sinusoidal" | "none"
    rope_theta: float = 10_000.0

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dispatch"       # "dispatch" (sort+scatter) | "alltoall" (shard_map)

    # SSM (mamba)
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 16              # within-chunk associative scan length

    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # misc
    norm_type: str = "rmsnorm"       # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"          # "swiglu" | "gelu"
    tie_embeddings: bool = False
    frontend: str = "none"           # "none" | "vision" | "audio"
    frontend_tokens: int = 0         # prefix positions fed by the (stub) frontend
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    remat: str = "full"              # "none" | "dots" | "full"
    attn_chunk: int = 1024           # flash-style q/kv chunk for train/prefill
    scan_layers: bool = True         # False: Python loop over groups (cost probes)
    # arch-specific rule overrides applied to decode cells (e.g. llama4's
    # bf16 experts need FSDP at decode)
    decode_rule_overrides: Dict[str, Optional[object]] = dataclasses.field(
        default_factory=dict)
    weight_quant: str = "none"       # "none" | "int8" (serve path)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"pattern period {len(self.layer_pattern)}"
        )

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(s.mixer in ("mamba", "rwkv") for s in self.layer_pattern)

    @property
    def has_full_attention(self) -> bool:
        return any(s.mixer in ("attn", "mla") for s in self.layer_pattern)

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    # logical->mesh rule overrides for this cell, e.g. {"act_kv_seq": "data"}
    rule_overrides: Dict[str, Optional[object]] = dataclasses.field(default_factory=dict)


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig(
    "long_500k", "decode", 524_288, 1,
    # batch of 1 cannot shard over data; shard the cache seq over both
    # mesh axes instead
    rule_overrides={"act_batch": None, "act_kv_seq": ("data", "model")},
)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


# ---------------------------------------------------------------------------
# registry

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.archs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    import repro_torch.configs.archs  # noqa: F401

    return sorted(_REGISTRY)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The assigned shape cells that apply to this arch.

    long_500k needs sub-quadratic attention: it runs for SSM/hybrid archs and
    is skipped (recorded) for pure full-attention archs. All assigned archs
    are decoder-style, so decode shapes apply to all.
    """
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not (
            cfg.is_attention_free or cfg.family == "hybrid"
        ):
            continue
        out.append(s)
    return tuple(out)
