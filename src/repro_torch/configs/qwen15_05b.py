"""qwen1.5-0.5b [dense]: 24L d=1024 16H (kv=16) d_ff=2816 vocab=151936.

QKV bias enabled. [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen15_05b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        act="silu",
        mlp_type="glu",
        rope_theta=1000000.0,
    )
