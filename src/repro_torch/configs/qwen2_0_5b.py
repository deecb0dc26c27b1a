"""qwen2-0.5b [dense] — GQA with QKV bias, tied embeddings.
[arXiv:2407.10671; hf:Qwen/Qwen2-0.5B]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, head_dim=64.
"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen2-0.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_936,
        qkv_bias=True,
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
