"""musicgen-medium [audio]: 48L d=1536 24H (kv=24) d_ff=6144 vocab=2048.

Decoder-only over EnCodec tokens; the EnCodec/text-conditioning frontend is a
STUB — input_specs() provides precomputed conditioning frame embeddings as a
prefix. [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        act="gelu",
        mlp_type="glu",
        frontend="audio_frames",
        num_prefix_tokens=64,    # precomputed conditioning frames
    )
