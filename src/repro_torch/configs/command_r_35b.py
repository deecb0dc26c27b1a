"""command-r-35b [dense] — GQA, no bias, parallel attn+mlp block, LayerNorm,
tied embeddings. [hf:CohereForAI/c4ai-command-r-v01; unverified]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""

from repro_torch.configs.base import ModelConfig, register


@register("command-r-35b")
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22_528,
        vocab_size=256_000,
        parallel_block=True,
        norm_type="layernorm",
        tie_embeddings=True,
        rope_theta=8_000_000.0,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=256, param_dtype="float32",
        activation_dtype="float32", remat="none", attn_chunk=64,
    )
