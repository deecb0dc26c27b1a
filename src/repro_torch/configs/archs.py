"""Imports every architecture module so the registry is populated; the
port's copy of ``repro.configs.archs``."""

from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    jamba_v01_52b,
    llama4_maverick_400b,
    llava_next_34b,
    minicpm3_4b,
    musicgen_medium,
    phi35_moe_42b,
    qwen2_0_5b,
    qwen3_4b,
    rwkv6_3b,
)

SMOKE = {
    "qwen2-0.5b": qwen2_0_5b.smoke,
    "command-r-35b": command_r_35b.smoke,
    "minicpm3-4b": minicpm3_4b.smoke,
    "qwen3-4b": qwen3_4b.smoke,
    "jamba-v0.1-52b": jamba_v01_52b.smoke,
    "rwkv6-3b": rwkv6_3b.smoke,
    "llava-next-34b": llava_next_34b.smoke,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.smoke,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.smoke,
    "musicgen-medium": musicgen_medium.smoke,
}


def smoke_config(name: str):
    return SMOKE[name]()
