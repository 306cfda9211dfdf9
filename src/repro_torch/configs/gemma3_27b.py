"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.

5:1 local:global sliding-window mix, 128k+ context, head_dim=128 (HF config —
not d_model/num_heads). [hf:google/gemma-3-*; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def gemma3_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        attn_type="sliding_mix",
        sliding_window=1024,
        global_every=6,          # 5 local : 1 global
        act="gelu",
        mlp_type="glu",
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=1000000.0,
    )
