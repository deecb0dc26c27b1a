"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf:facebook/musicgen-medium]
48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048, GELU MLP, LayerNorm,
sinusoidal positions.

The EnCodec frontend is a stub: input_specs() provides
precomputed frame embeddings for the audio-prompt prefix; the text-
conditioning cross-attention of the original is out of scope (the backbone
cells are the assigned LM shapes). Codebook interleaving (delay pattern) is
a data-layout concern handled upstream of the model.
"""

from repro_torch.configs.base import ModelConfig, register


@register("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        norm_type="layernorm",
        mlp_act="gelu",
        pos_embed="sinusoidal",
        frontend="audio",
        frontend_tokens=512,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, frontend_tokens=8,
        param_dtype="float32", activation_dtype="float32", remat="none",
        attn_chunk=64,
    )
