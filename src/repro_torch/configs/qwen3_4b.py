"""qwen3-4b [dense] — GQA + qk_norm, no bias. [hf:Qwen/Qwen3-4B]
36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim=128.
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, param_dtype="float32",
        activation_dtype="float32", remat="none", attn_chunk=64,
    )
