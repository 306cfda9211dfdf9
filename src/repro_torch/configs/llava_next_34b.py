"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Backbone only; the anyres vision tower is a STUB — input_specs() provides
precomputed patch embeddings as a prefix. [hf:llava-hf/...; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        act="silu",
        mlp_type="glu",
        frontend="vision_patches",
        num_prefix_tokens=128,   # anyres patch embeddings (stub)
        rope_theta=5000000.0,
    )
