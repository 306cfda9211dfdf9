"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. Mamba2 backbone + shared attention block (applied every 6th
layer with shared weights; the shared block carries the d_ff=8192 MLP).
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def zamba2_12b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        block_pattern="zamba",
        ssm_state=64,
        mamba_headdim=64,
        shared_attn_every=6,
        pos="rope",
        act="gelu",
        mlp_type="glu",
        la_chunk=128,
    )
