"""llava-next-34b [vlm] — anyres tiling over a 34B text backbone.
[hf:llava-hf/llava-v1.6-34b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

The vision frontend is a stub: input_specs() provides
precomputed patch embeddings (B, frontend_tokens, d_model) which replace the
first positions of the token stream. anyres tile *selection* is where the
paper's technique plugs in: repro_torch.data.pipeline.anyres_select ranks
candidate crops by yCHG hyperedge density.
"""

from repro_torch.configs.base import ModelConfig, register


@register("llava-next-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20_480,
        vocab_size=64_000,
        frontend="vision",
        frontend_tokens=2880,  # 5 anyres tiles x 576 patches
        rope_theta=5_000_000.0,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=256, frontend_tokens=8,
        param_dtype="float32", activation_dtype="float32", remat="none",
        attn_chunk=64,
    )
