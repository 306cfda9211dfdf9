"""Three-term roofline model for the NVIDIA H100 SXM5 80GB HBM3:

    compute    = FLOPs_per_device / PEAK_FLOPS["bfloat16"]
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW

MODEL_FLOPS ("useful" flops) is computed analytically from the config and
shape: matmul params in the forward path (attention/MLP/MoE-active/
adapters/head) plus attention score/AV flops (causal-halved,
window-clipped), times the workload factor: 4x for masks-only xpeft
training (fwd + activation-grad bwd; frozen weight grads are not
computed), 6x for full training, 2x for inference. The arithmetic is
``repro.analysis.roofline``'s; only the card's constants differ.

Every kernel bound that ``chip_smoke.py`` prints reads these constants.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM5 80GB HBM3 at its 700 W power limit, NVIDIA's data
# sheet: dense tensor-core peaks (no sparsity) per card, FLOP/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the same card's HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
# the same card's NVLink 4 bandwidth: 450 GB/s in each direction, 900 GB/s
# both together. The collective term uses ONE direction: a device's
# collective bytes leave it through its outgoing links.
NVLINK_BW = 450e9


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> Dict[str, float]:
    t_c = flops_per_dev / PEAK_FLOPS["bfloat16"]
    t_m = bytes_per_dev / HBM_BW
    t_x = coll_bytes_per_dev / NVLINK_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    total = max(t_c, t_m, t_x)
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom[1], "bound_s": total,
            "compute_frac_of_bound": t_c / total if total else 0.0}


# ----------------------------------------------------------------------------
# Analytic "useful" FLOPs
# ----------------------------------------------------------------------------

def matmul_params(cfg) -> int:
    """Active matmul parameters touched per token in the forward pass."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = 0
    if cfg.block_pattern == "attn":
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if cfg.moe:
            mlp = d * cfg.num_experts + cfg.top_k * 3 * d * ff
        else:
            mlp = (3 if cfg.mlp_type == "glu" else 2) * d * ff
        per_layer = attn + mlp
        total = L * per_layer
    elif cfg.block_pattern == "rwkv":
        tm = 5 * d * (H * hd) + (H * hd) * d + d * 64 + 64 * H * hd
        cm = 2 * d * ff + d * d
        total = L * (tm + cm)
    elif cfg.block_pattern in ("mamba", "zamba"):
        d_inner = 2 * d
        nheads = d_inner // cfg.mamba_headdim
        in_dim = 2 * d_inner + 2 * cfg.ssm_state + nheads
        total = L * (d * in_dim + d_inner * d)
        if cfg.block_pattern == "zamba":
            n_inv = L // cfg.shared_attn_every
            attn = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * ff
            total += n_inv * attn
    else:
        total = 0
    # X-PEFT adapter application: 2·d·b per adapted layer
    if cfg.xpeft.enabled:
        total += L * 2 * d * cfg.xpeft.bottleneck
    # LM head (tied or not, the logits matmul runs)
    total += d * cfg.vocab_size
    return int(total)


def _attn_flops_per_seq(cfg, T: int, decode_ctx: int = 0) -> float:
    """Score+AV flops for ONE sequence (forward)."""
    H, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    if cfg.block_pattern == "rwkv":
        c = cfg.la_chunk
        return L * T * (2 * c * (hd + hd) + 4 * hd * hd) * cfg.num_heads / 2
    if cfg.block_pattern in ("mamba", "zamba"):
        d_inner = 2 * cfg.d_model
        nheads = d_inner // cfg.mamba_headdim
        c = cfg.la_chunk
        n, p = cfg.ssm_state, cfg.mamba_headdim
        fl = L * nheads * T * (c * (n + p) + 4 * n * p) / 2
        if cfg.block_pattern == "zamba":
            n_inv = L // cfg.shared_attn_every
            if decode_ctx:
                fl += n_inv * 4 * decode_ctx * H * hd
            else:
                fl += n_inv * 2 * T * T * H * hd  # causal-halved
        return fl
    # attention archs
    if decode_ctx:  # one new token vs ctx
        per_layer_global = 4 * decode_ctx * H * hd
        per_layer_local = 4 * min(decode_ctx, cfg.sliding_window) * H * hd
    else:
        per_layer_global = 2 * T * T * H * hd          # causal-halved 4T²/2
        w = min(cfg.sliding_window, T)
        per_layer_local = 4 * T * w * H * hd / 2
    if cfg.attn_type == "sliding_mix":
        ng = cfg.num_layers // cfg.global_every
        nl = cfg.num_layers - ng
        return ng * per_layer_global + nl * per_layer_local
    return cfg.num_layers * per_layer_global


def model_flops(cfg, shape, num_devices: int,
                workload: str = "xpeft") -> float:
    """Per-device 'useful' FLOPs for one step of this cell."""
    Np = matmul_params(cfg)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        factor = 4.0 if workload == "xpeft" else 6.0
        tokens = B * (T + cfg.num_prefix_tokens)
        fl = factor * Np * tokens \
            + (factor / 2) * B * _attn_flops_per_seq(cfg, T)
    elif shape.kind == "prefill":
        tokens = B * (T + cfg.num_prefix_tokens)
        fl = 2.0 * Np * tokens + B * _attn_flops_per_seq(cfg, T)
    else:  # decode: one token per sequence against ctx = T
        fl = 2.0 * Np * B + B * _attn_flops_per_seq(cfg, 1, decode_ctx=T)
        if cfg.xpeft.enabled:
            # baseline decode re-aggregates masks against the bank each step
            xp = cfg.xpeft
            fl += 2.0 * B * cfg.num_layers * 2 * xp.num_adapters \
                * cfg.d_model * xp.bottleneck
    return fl / num_devices
