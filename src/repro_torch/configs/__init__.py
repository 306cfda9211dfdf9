"""Arch registry: importing this package registers every config."""
from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    LONG_CONTEXT_ARCHS,
    ModelConfig,
    ShapeConfig,
    XPeftConfig,
    get_config,
    get_shape,
    list_archs,
    reduce_for_smoke,
    shapes_for,
)

# per-arch modules (registration side effects)
from repro_torch.configs import (  # noqa: F401
    bert_base_xpeft,
    dbrx_132b,
    deepseek_7b,
    gemma3_27b,
    gemma_2b,
    llava_next_34b,
    musicgen_medium,
    qwen15_05b,
    qwen3_moe_30b,
    rwkv6_7b,
    zamba2_12b,
)

ASSIGNED_ARCHS = (
    "gemma-2b",
    "deepseek-7b",
    "gemma3-27b",
    "qwen1.5-0.5b",
    "dbrx-132b",
    "qwen3-moe-30b-a3b",
    "rwkv6-7b",
    "musicgen-medium",
    "zamba2-1.2b",
    "llava-next-34b",
)
