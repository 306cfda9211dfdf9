"""bert-base-xpeft [encoder] — the PAPER's own configuration.

bert-base-uncased: 12L d=768 12H d_ff=3072 vocab=30522, learned positions,
LayerNorm, vanilla GeLU FFN, classification head. X-PEFT defaults match the
paper: Pfeiffer r=16 -> bottleneck b=48, N adapters, k=50 hard masks.
"""
from repro_torch.configs.base import ModelConfig, register


@register
def bert_base_xpeft() -> ModelConfig:
    cfg = ModelConfig(
        name="bert-base-xpeft",
        family="encoder",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=30522,
        causal=False,
        pos="learned",
        max_seq_len=512,
        norm="layernorm",
        act="gelu",
        mlp_type="vanilla",
        num_labels=15,           # LaMP news categories
    )
    return cfg.with_xpeft(num_adapters=100, bottleneck=48, k=50,
                          mask_type="hard", max_profiles=512)
