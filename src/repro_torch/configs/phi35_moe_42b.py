"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2, every layer MoE.
[hf:microsoft/Phi-3.5-MoE-instruct]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 (per expert) vocab=32064.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register


@register("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32_064,
        layer_pattern=(LayerSpec("attn", "moe"),),
        num_experts=16,
        experts_per_token=2,
        norm_type="layernorm",
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, num_experts=4, experts_per_token=2,
        moe_capacity_factor=4.0,
        param_dtype="float32", activation_dtype="float32", remat="none",
        attn_chunk=64,
    )
