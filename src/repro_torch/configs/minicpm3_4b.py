"""minicpm3-4b [dense] — MLA (multi-head latent attention).
[hf:openbmb/MiniCPM3-4B]
62L d_model=2560 40H d_ff=6400 vocab=73448; MLA: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64. The decode path uses the absorbed-matmul
formulation against the compressed (kv_lora + rope) cache.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register


@register("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        head_dim=96,  # qk_nope + qk_rope
        d_ff=6400,
        vocab_size=73_448,
        layer_pattern=(LayerSpec("mla", "mlp"),),
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_rope_dim=32,
        qk_nope_dim=64,
        v_head_dim=64,
        tie_embeddings=True,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=24,
        d_ff=128, vocab_size=256, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
        param_dtype="float32", activation_dtype="float32", remat="none",
        attn_chunk=64,
    )
