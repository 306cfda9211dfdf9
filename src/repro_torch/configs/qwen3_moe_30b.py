"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) per-expert d_ff=768
vocab=151936, MoE 128 experts top-8. head_dim=128 (HF config).
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def qwen3_moe_30b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        moe=True,
        num_experts=128,
        top_k=8,
        act="silu",
        mlp_type="glu",
        rope_theta=1000000.0,
    )
