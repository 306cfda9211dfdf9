"""deepseek-7b [dense]: 30L d=4096 32H (kv=32) d_ff=11008 vocab=102400.

Llama-architecture (SwiGLU, RoPE, RMSNorm). [arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def deepseek_7b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
        act="silu",
        mlp_type="glu",
        rope_theta=10000.0,
    )
