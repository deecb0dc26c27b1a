"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
MoE interleaved every other layer, early-fusion multimodal.
[hf:meta-llama/Llama-4-Maverick-17B-128E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

Early fusion = image tokens share the decoder stream; the vision frontend is
a stub (precomputed patch embeddings as a prefix), same contract as llava.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register


@register("llama4-maverick-400b-a17b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        # dense layer / MoE layer interleave (interleave_moe_layer_step=2)
        layer_pattern=(LayerSpec("attn", "mlp"), LayerSpec("attn", "moe")),
        num_experts=128,
        experts_per_token=1,   # top-1 sigmoid gate + always-on shared expert
        frontend="vision",
        frontend_tokens=1024,
        rope_theta=500_000.0,
        param_dtype="bfloat16",
        # the bf16 weights need FSDP even at inference (model-axis-only
        # sharding does not fit); production decode for this arch wants a
        # bigger mesh or int8 weights
        decode_rule_overrides={"embed": "data"},
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, num_experts=4, experts_per_token=1,
        moe_capacity_factor=4.0, frontend_tokens=8,
        param_dtype="float32", activation_dtype="float32", remat="none",
        attn_chunk=64,
    )
