"""Config system: model / X-PEFT / shape / run configs and the arch registry.

Every assigned architecture is a `ModelConfig` built in its own module under
``repro_torch.configs``; ``get_config(name)`` resolves it, and
``reduce_for_smoke(cfg)`` derives the CPU-runnable reduced config of the same
family used by the per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


# Adapter families a bank segment can hold (heterogeneous banks): the
# mask index space is ONE contiguous [0, N) range partitioned into typed
# segments; a profile's k-sparse mask selects across families and
# aggregation produces one per-type aggregate per layer.
ADAPTER_TYPES = ("bottleneck", "lora", "ia3", "prefix")

MASK_TYPES = ("soft", "hard")
AGGREGATES = ("dense", "sparse")
BANK_QUANTS = ("none", "int8", "int4")
KERNEL_IMPLS = ("auto", "ref")


@dataclass(frozen=True)
class XPeftConfig:
    """The paper's technique as a first-class feature of the framework."""

    enabled: bool = True
    num_adapters: int = 256          # N — size of the shared adapter bank
    bottleneck: int = 64             # b — adapter bottleneck dim
    k: int = 50                      # top-k for hard masks
    mask_type: str = "hard"          # "soft" | "hard"
    tau: float = 1.0                 # gumbel-softmax temperature
    nu: float = 1.0                  # gumbel noise level
    adapter_activation: str = "gelu"  # "gelu" | "identity" (literal paper form)
    # "dense": masks @ bank einsum (soft or ST-hard training path)
    # "sparse": k-sparse gather-sum (inference / frozen-index training)
    aggregate: str = "dense"
    # kernel backend for adapter application/aggregation hot paths
    # (kernels/ops.py): "auto" = the hand-written CUDA kernel on a CUDA
    # tensor, the plain PyTorch version on a CPU tensor; "ref" forces the
    # plain version even on the card (the end-to-end reference run).
    kernel_impl: str = "auto"
    # serving-side bank/record quantization (repro/quant): "none" keeps the
    # bf16/fp32 bank bitwise-identical to the unquantized path; "int8" is
    # symmetric per-row with fp16 scales; "int4" is group-wise packed.
    # Training always stays bf16/fp32 — only the serve hot paths (k-sparse
    # admission aggregation, decode) read quantized rows, dequantized
    # in-register by the kernels in kernels/*_quant.py.
    bank_quant: str = "none"         # "none" | "int8" | "int4"
    quant_group: int = 32            # int4 group-size upper bound (per row)
    max_profiles: int = 1024         # rows in the per-profile mask table
    # Heterogeneous bank layout: ((type, count), ...) partitioning the N
    # mask indices into typed segments in order. () means the type-pure
    # bottleneck bank — the historical layout, bitwise-identical to the
    # pre-hetero code paths. LoRA pairs share the bottleneck rank (b) so
    # the k-sparse aggregation kernels are reused row-for-row; IA3 rows
    # are d-vector scale DELTAS (selected sum s, applied as x * (1 + s));
    # prefix rows are `prefix_tokens` learned post-RoPE KV positions.
    bank_spec: Tuple[Tuple[str, int], ...] = ()
    prefix_tokens: int = 4           # virtual KV tokens per prefix slot

    def __post_init__(self):
        # normalize bank_spec (lists from JSON/kwargs -> hashable tuples)
        spec = tuple((str(t), int(c)) for t, c in self.bank_spec)
        object.__setattr__(self, "bank_spec", spec)
        if self.mask_type not in MASK_TYPES:
            raise ValueError(
                f"mask_type {self.mask_type!r} not in {MASK_TYPES}")
        if self.aggregate not in AGGREGATES:
            raise ValueError(
                f"aggregate {self.aggregate!r} not in {AGGREGATES}")
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError(
                f"kernel_impl {self.kernel_impl!r} not in {KERNEL_IMPLS} "
                "(the Pallas backends have no counterpart in the port)")
        if self.bank_quant not in BANK_QUANTS:
            raise ValueError(
                f"bank_quant {self.bank_quant!r} not in {BANK_QUANTS}")
        if self.k > self.num_adapters:
            raise ValueError(
                f"k={self.k} > num_adapters={self.num_adapters}: a hard "
                "mask cannot select more rows than the bank holds")
        for t, c in spec:
            if t not in ADAPTER_TYPES:
                raise ValueError(
                    f"bank_spec type {t!r} not in {ADAPTER_TYPES}")
            if c <= 0:
                raise ValueError(f"bank_spec count {c} for {t!r} must be "
                                 "positive")
        if spec and sum(c for _, c in spec) != self.num_adapters:
            raise ValueError(
                f"bank_spec counts {[c for _, c in spec]} sum to "
                f"{sum(c for _, c in spec)} != num_adapters="
                f"{self.num_adapters} — segments must tile the mask "
                "index space exactly")

    def segments(self) -> Tuple[Tuple[str, int, int], ...]:
        """((type, offset, count), ...) over the unified [0, N) index
        space; the empty bank_spec resolves to one bottleneck segment."""
        spec = self.bank_spec or (("bottleneck", self.num_adapters),)
        out, off = [], 0
        for t, c in spec:
            out.append((t, off, c))
            off += c
        return tuple(out)

    @property
    def is_hetero(self) -> bool:
        """True iff any non-bottleneck segment exists — every hetero code
        path is gated on this so type-pure configs keep the exact
        (bitwise) historical code paths."""
        return any(t != "bottleneck" for t, _ in self.bank_spec)

    @property
    def has_prefix(self) -> bool:
        return any(t == "prefix" for t, _ in self.bank_spec)

    def segment_counts(self) -> dict:
        """{type: total count} over the resolved segments."""
        out = {}
        for t, _, c in self.segments():
            out[t] = out.get(t, 0) + c
        return out


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm|encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attn_type: str = "full"          # "full" | "sliding_mix" | "none"
    sliding_window: int = 1024
    global_every: int = 6            # gemma3: 1 global layer per this many
    qkv_bias: bool = False
    causal: bool = True
    pos: str = "rope"                # "rope" | "learned" | "none"
    rope_theta: float = 10000.0
    max_seq_len: int = 524288
    logit_softcap: float = 0.0

    # mlp
    act: str = "silu"                # glu gate activation (silu=SwiGLU, gelu=GeGLU)
    mlp_type: str = "glu"            # "glu" | "vanilla"

    # moe
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "sort"           # "sort" | "dense"

    # ssm / hybrid
    block_pattern: str = "attn"      # "attn" | "rwkv" | "mamba" | "zamba"
    ssm_state: int = 64
    mamba_headdim: int = 64
    shared_attn_every: int = 6       # zamba2 shared attention cadence
    la_chunk: int = 128              # chunked linear-attention chunk length

    # modality frontend (stub: embeddings arrive precomputed via input_specs)
    frontend: str = "none"           # "none" | "audio_frames" | "vision_patches"
    num_prefix_tokens: int = 0

    # decode fast path (serve): `decode_fused` routes T=1 cached decode
    # through the per-layer megakernel (kernels/decode_fused.py — norm,
    # attention, MLP and the X-PEFT adapter in ONE program per layer,
    # backend picked by xpeft.kernel_impl); `spec_enable` turns on
    # self-speculative decoding in the continuous engine: the bare PLM
    # (zero-adapter masks, bitwise the frozen model) drafts `spec_gamma`
    # tokens per slot and the adapted model verifies them in one
    # prefill-shaped step. The two are exclusive per engine: the verify
    # forward runs at T=gamma+1 where the megakernel does not apply, so
    # mixing them would break the spec-vs-nonspec bitwise parity gate.
    decode_fused: bool = False
    spec_enable: bool = False
    spec_gamma: int = 3              # draft tokens per speculation round

    # misc
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    cache_dtype: str = ""            # KV cache dtype ("" = model dtype);
                                     # e.g. "float8_e4m3fn" halves cache BW
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma multiplies embeddings by sqrt(d)
    dtype: str = "bfloat16"
    remat: str = "full"              # "none" | "full" | "dots"
    num_labels: int = 0              # classification head width (encoder/paper)

    xpeft: XPeftConfig = field(default_factory=XPeftConfig)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def with_xpeft(self, **kw) -> "ModelConfig":
        return replace(self, xpeft=replace(self.xpeft, **kw))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


# The LM shape set assigned to every arch in the pool.
LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

# Archs allowed to run long_500k (sub-quadratic long-context decode); the
# rest skip it per DESIGN.md §4. gemma3 qualifies via 5:1 sliding windows,
# rwkv6 via O(1) state, zamba2 as the hybrid.
LONG_CONTEXT_ARCHS = frozenset({"rwkv6-7b", "zamba2-1.2b", "gemma3-27b"})


# the paper's own training shape (bert-base + GLUE: seq 128, batch 64)
PAPER_SHAPE = ShapeConfig("paper_128", 128, 64, "train")


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES + (PAPER_SHAPE,):
        if s.name == name:
            return s
    raise KeyError(name)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells this arch actually runs (skips documented in DESIGN.md)."""
    out = []
    for s in LM_SHAPES:
        if s.kind == "decode" and cfg.family == "encoder":
            continue  # encoder-only: no decode step
        if s.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
            continue  # pure full-attention: quadratic-context skip
        out.append(s)
    return tuple(out)


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------
_REGISTRY = {}


def register(fn):
    """Decorator: register a zero-arg config function under its cfg.name."""
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests.

    Keeps the structural features (GQA ratio, GLU type, MoE routing, block
    pattern, sliding mix, prefix frontend) and shrinks every dimension.
    """
    kv = max(1, min(cfg.num_kv_heads, 2 if cfg.num_kv_heads < cfg.num_heads else 4))
    heads = 4
    if cfg.num_kv_heads == cfg.num_heads:
        kv = heads
    elif cfg.num_kv_heads == 1:
        kv = 1
    else:
        kv = 2
    small = cfg.with_(
        num_layers=4 if cfg.block_pattern == "zamba" else 2,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=96 if not cfg.moe else 32,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8) if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        sliding_window=8,
        global_every=2,
        shared_attn_every=2,
        ssm_state=8,
        mamba_headdim=8,
        la_chunk=8,
        num_prefix_tokens=4 if cfg.num_prefix_tokens else 0,
        max_seq_len=256,
        remat="none",
        dtype="float32",
    )
    return small.with_xpeft(num_adapters=8, bottleneck=4, k=2, max_profiles=8)
