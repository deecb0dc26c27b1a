"""rwkv6-3b "Finch" [ssm] — attention-free, data-dependent decay.
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]
32L d_model=2560 d_ff=8960 vocab=65536; head dim 64 -> 40 heads.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register


@register("rwkv6-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,       # d_model / rwkv_head_dim
        num_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65_536,
        layer_pattern=(LayerSpec("rwkv", "rwkv_ffn"),),
        rwkv_head_dim=64,
        rwkv_decay_lora=64,
        rwkv_mix_lora=32,
        norm_type="layernorm",
        pos_embed="none",
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=8, head_dim=8,
        d_ff=128, vocab_size=256, rwkv_head_dim=8, rwkv_decay_lora=8,
        rwkv_mix_lora=4, ssm_chunk=4,
        param_dtype="float32", activation_dtype="float32", remat="none",
    )
