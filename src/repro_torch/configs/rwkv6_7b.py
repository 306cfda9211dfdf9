"""rwkv6-7b [ssm]: 32L d=4096 attention-free d_ff=14336 vocab=65536.

Finch: data-dependent per-channel decay. head_size=64 -> 64 heads.
[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def rwkv6_7b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,            # d_model / head_size(64)
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        attn_type="none",
        block_pattern="rwkv",
        pos="none",
        act="sqrelu",
        la_chunk=128,
    )
