"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE every
other layer (16 experts, top-2). [arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Period-8 pattern (attention at index 4, MoE on odd indices) — matches the
paper's jamba block: 8 layers, 1 attention, MoE applied every 2 layers.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, register


def _pattern():
    out = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        channel = "moe" if i % 2 == 1 else "mlp"
        out.append(LayerSpec(mixer, channel))
    return tuple(out)


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14_336,
        vocab_size=65_536,
        layer_pattern=_pattern(),
        num_experts=16,
        experts_per_token=2,
        ssm_state_dim=16,
        ssm_conv_dim=4,
        ssm_expand=2,
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_experts=4, experts_per_token=2,
        moe_capacity_factor=4.0, ssm_chunk=4,
        param_dtype="float32", activation_dtype="float32", remat="none",
        attn_chunk=64,
    )
