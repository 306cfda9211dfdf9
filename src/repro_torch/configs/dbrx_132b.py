"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.

MoE: 16 experts, top-4 (fine-grained). [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def dbrx_132b() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab_size=100352,
        moe=True,
        num_experts=16,
        top_k=4,
        act="silu",
        mlp_type="glu",
        rope_theta=500000.0,
    )
