"""gemma-2b [dense]: 18L d=2048 8H MQA(kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256, MQA. [arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def gemma_2b() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        act="gelu",              # GeGLU
        mlp_type="glu",
        embed_scale=True,
        tie_embeddings=True,     # gemma ties lm_head to embeddings
        rope_theta=10000.0,
    )
