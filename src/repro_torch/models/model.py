"""The LM: a loop over stacked transformer layers with X-PEFT adapter hooks.

The port of ``repro.models.model`` for every block pattern: causal
decoders with RoPE, dense or mixture-of-experts (``models/moe.py`` in
place of the MLP; the forward's aux is the mean of the layers' load-
balance losses, as JAX's), full attention or gemma3's ``sliding_mix``
(``layer_meta``'s per-layer global flags, a Python bool per layer into
``attention``), gemma's embedding scale (the token rows times sqrt(d)
rounded to fp32 and then to x's dtype, JAX's ``jnp.sqrt(d).astype``),
the frontends' ``prefix_embeds`` (the vision patches or audio frames,
cast to x's dtype and put unscaled in front of the token rows, the
positions running over both), and the encoder
(``bert-base-xpeft``: learned positions, bidirectional attention,
LayerNorm, the vanilla GELU MLP and the classification head,
``cls_logits``). Params are plain dicts of tensors in the JAX package's
layouts, layers stacked on a leading L axis; the ``lax.scan`` over layers
becomes a Python loop over that axis. A serving mesh holds its
model-sharded leaves as ``distributed.sharding.Sharded`` blocks: the loop
gathers each layer's whole before use (the embedding looks its rows up
on the rank that holds them), so every layer runs its one-device code;
under autograd each such layer is a checkpoint, gathered again in the
backward. Without a cache, under autograd, every layer follows
``cfg.remat`` as JAX's ``_remat`` wraps it (``_remat_kw``). A MoE layer
under JAX's expert-parallel condition
(``models/moe.py``'s ``ep_mesh``) keeps its experts as this rank's blocks.
With ``cfg.decode_fused`` a T=1
cached decode step runs the decode megakernel once per layer in place of
attention + MLP + adapter (``_decode_fused_route``, as JAX decides it).
A heterogeneous bank's entries (``lora_a``, ``ia3_s``, ``prefix_skip``)
compose in JAX's fixed order, bottleneck -> LoRA -> IA3 (two or three of
them in one ``ops.hetero_adapter`` launch per layer), with each layer's
``prefix_skip`` gating the prefix KV rows the engine hydrated into the
cache. The on-the-fly mask routes (``w_a``/``w_b`` weights, dense or with
``idx_a``/``idx_b`` over the k selected rows) aggregate against the
layer's bank slice in plain torch ops: the uncached forward is
differentiable in ``profile_masks`` (training), and per-step serving
takes the same route; over a heterogeneous bank it aggregates each typed
segment (bottleneck -> LoRA -> IA3), and without a cache each layer's
prefix KV rows ride into attention as ``extra_kv``, the prompt's
positions shifted by P for the examples that select a prefix slot.
The recurrent block patterns run on the shared chunked linear attention
(``models/linear_attn.py``): ``rwkv`` (RWKV6, ``models/rwkv.py``) and
``mamba`` (Mamba2, ``models/mamba.py``) layers, and ``zamba``, Mamba2
layers in groups of ``shared_attn_every`` with ONE attention block of
shared weights after each whole group (``params["shared_attn"]``, full
attention, no MoE, no adapter after it, its own K/V cache slice per
invocation); the adapter follows every recurrent layer as it follows an
attention block. Their state leaves are written into the cache IN PLACE
after each layer, as the attention blocks write K/V: the continuous
engine's resident leaves reach its pool only that way.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import xpeft as XP
from repro_torch.core.adapters import init_adapter_bank, init_hetero_bank
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import attention as ATT
from repro_torch.models import mamba as MB
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RK
from repro_torch.models.common import dense_init, init_norm, norm_apply, \
    softcap
from repro_torch.utils import generator, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# a cache may also hold float8 (JAX's ``cache_dtype="float8_e4m3fn"``):
# rows are rounded to it on write and read back in the compute dtype
_CACHE_DTYPES = dict(_DTYPES, float8_e4m3fn=torch.float8_e4m3fn)


def torch_dtype(name: str, *, cache: bool = False) -> torch.dtype:
    table = _CACHE_DTYPES if cache else _DTYPES
    if name not in table:
        raise NotImplementedError(f"dtype {name!r} is not ported "
                                  "(ROADMAP queue 1, item 2)")
    return table[name]


BLOCK_PATTERNS = ("attn", "rwkv", "mamba", "zamba")


def check_supported(cfg) -> None:
    """Raise for a block pattern the model does not know."""
    if cfg.block_pattern not in BLOCK_PATTERNS:
        raise NotImplementedError(
            f"unknown block_pattern {cfg.block_pattern!r} (known: "
            f"{', '.join(BLOCK_PATTERNS)})")


def layer_meta(cfg) -> list:
    """Static per-layer flags: is_global (gemma3's 5 local : 1 global)."""
    if cfg.attn_type == "sliding_mix":
        return [l % cfg.global_every == cfg.global_every - 1
                for l in range(cfg.num_layers)]
    return [True] * cfg.num_layers


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------

def _init_attn_block(cfg, dtype, gen, device) -> dict:
    block = {
        "attn": ATT.init_attention(cfg, dtype, generator=gen, device=device),
        "n1": init_norm(cfg.norm, cfg.d_model, device=device),
        "n2": init_norm(cfg.norm, cfg.d_model, device=device),
    }
    if cfg.moe:
        block["moe"] = MOE.init_moe(cfg, dtype, generator=gen, device=device)
    else:
        block["mlp"] = MLP.init_mlp(cfg, dtype, generator=gen, device=device)
    return block


def _init_block(cfg, dtype, gen, device) -> dict:
    kw = dict(generator=gen, device=device)
    if cfg.block_pattern == "rwkv":
        return {"rwkv": RK.init_rwkv_block(cfg, dtype, **kw),
                "n1": init_norm("rmsnorm", cfg.d_model, device=device),
                "n2": init_norm("rmsnorm", cfg.d_model, device=device)}
    if cfg.block_pattern in ("mamba", "zamba"):
        return {"mamba": MB.init_mamba_block(cfg, dtype, **kw),
                "n1": init_norm("rmsnorm", cfg.d_model, device=device)}
    return _init_attn_block(cfg, dtype, gen, device)


def shared_attn_cfg(cfg):
    """The config of zamba's shared attention block."""
    return cfg.with_(attn_type="full", moe=False)


def _init_blocks(cfg, dtype, gen, device) -> dict:
    """The L blocks, drawn in layer order and copied into stacked leaves
    as they come: one layer's draw is held beside the stack, never all L
    (qwen3-moe-30b-a3b's experts alone are 58 GB in bf16)."""
    stacked = None
    # on meta (no generator) one layer's shapes stand for every layer's
    for l in range(cfg.num_layers if gen is not None else 1):
        block = _init_block(cfg, dtype, gen, device)
        if stacked is None:
            stacked = {name: {k: torch.empty((cfg.num_layers,) + v.shape,
                                             dtype=v.dtype, device=v.device)
                              for k, v in sub.items()}
                       for name, sub in block.items()}
        for name, sub in block.items():
            for k, v in sub.items():
                stacked[name][k][l] = v
    return stacked


def init_lm(cfg, *, seed: int = 0, device=None) -> dict:
    """Random weights drawn on ``device`` (the card unless ``"cpu"``) from
    one ``torch.Generator`` seeded with ``seed``; same tree and layouts as
    ``repro.models.init_lm``."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = generator(device, seed)
    kw = dict(generator=gen, device=device)
    params = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), cfg.d_model,
                            dtype, **kw),
        "blocks": _init_blocks(cfg, dtype, gen, device),
        "final_norm": init_norm(cfg.norm, cfg.d_model, device=device),
    }
    if cfg.pos == "learned":
        params["pos_embed"] = dense_init((cfg.max_seq_len, cfg.d_model),
                                         cfg.d_model, dtype, **kw)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size),
                                       cfg.d_model, dtype, **kw)
    if cfg.block_pattern == "zamba":
        params["shared_attn"] = _init_attn_block(shared_attn_cfg(cfg), dtype,
                                                 gen, device)
    if cfg.num_labels:
        d, C, f32 = cfg.d_model, cfg.num_labels, torch.float32
        params["cls"] = {
            "pool_w": dense_init((d, d), d, f32, **kw),
            "pool_b": torch.zeros((d,), dtype=f32, device=device),
            "head_w": dense_init((d, C), d, f32, **kw),
            "head_b": torch.zeros((C,), dtype=f32, device=device),
        }
    if cfg.xpeft.enabled and cfg.xpeft.is_hetero:
        params["xpeft_bank"] = init_hetero_bank(
            cfg.num_layers, cfg.xpeft, cfg.d_model, cfg.kv_dim, dtype, **kw)
    elif cfg.xpeft.enabled:
        params["xpeft_bank"] = init_adapter_bank(
            cfg.num_layers, cfg.xpeft.num_adapters, cfg.d_model,
            cfg.xpeft.bottleneck, dtype, **kw)
    return params


# ----------------------------------------------------------------------------
# KV / recurrent cache
# ----------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq: int, *, device, dtype=None) -> dict:
    """Zeroed cache, layers stacked on a leading axis: K/V [L, B, S, KV,
    hd] for attention blocks; rwkv's ``tm_last``/``cm_last``/``wkv`` and
    mamba's ``conv``/``ssd`` [L, B, ...] (their recurrent leaves fp32);
    zamba's mamba leaves plus ``attn_k``/``attn_v`` [n_inv, B, S, KV, hd],
    one slice per shared-block invocation."""
    check_supported(cfg)
    dtype = dtype or torch_dtype(cfg.cache_dtype or cfg.dtype, cache=True)
    L = cfg.num_layers
    if cfg.block_pattern == "rwkv":
        return RK.init_rwkv_state(batch, cfg, dtype, lead=(L,),
                                  device=device)
    if cfg.block_pattern in ("mamba", "zamba"):
        cache = MB.init_mamba_state(batch, cfg, dtype, lead=(L,),
                                    device=device)
        if cfg.block_pattern == "zamba":
            shape = (L // cfg.shared_attn_every, batch, seq,
                     cfg.num_kv_heads, cfg.head_dim)
            cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
            cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return cache
    shape = (L, batch, seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------

def _xpeft_apply(x, bank_l, masks_l, cfg):
    """The layer's adapter on x [B, T, d]: ``bank_l`` is the layer's slice
    of the bank (read only by the on-the-fly mask routes), ``masks_l`` the
    layer's slice of ``profile_masks``."""
    if masks_l is None or not cfg.xpeft.enabled:
        return x
    if "a_q" in masks_l:
        # quantized aggregated records (bank_quant serving): int8 / planar
        # int4 Â/B̂ with fp16 scales, dequantized inside the kernel
        return ops.fused_adapter_quant(
            x, masks_l["a_q"], masks_l["a_scale"], masks_l["b_q"],
            masks_l["b_scale"], masks_l["ln_scale"], masks_l["ln_bias"],
            scheme=cfg.xpeft.bank_quant,
            activation=cfg.xpeft.adapter_activation,
            impl=cfg.xpeft.kernel_impl)
    if "w_a" in masks_l:
        # on-the-fly mask weights (training, per-step serving): aggregate
        # against the layer's bank slice and apply, in plain torch ops
        ln_s = masks_l["ln_scale"][..., None, :]
        ln_b = masks_l["ln_bias"][..., None, :]
        if "idx_a" in masks_l:
            return XP.apply_xpeft_layer_sparse(
                x, bank_l, masks_l["idx_a"], masks_l["w_a"],
                masks_l["idx_b"], masks_l["w_b"], ln_s, ln_b, cfg.xpeft)
        if cfg.xpeft.is_hetero:
            # dense weights over a typed bank: per-segment aggregation,
            # bottleneck -> LoRA -> IA3 (the prefix rows went to attention)
            return XP.apply_xpeft_layer_hetero(
                x, bank_l, masks_l["w_a"], masks_l["w_b"], ln_s, ln_b,
                cfg.xpeft)
        return XP.apply_xpeft_layer(x, bank_l, masks_l["w_a"],
                                    masks_l["w_b"], ln_s, ln_b, cfg.xpeft)
    # admission-time aggregated adapters; a heterogeneous entry composes in
    # the fixed per-layer order bottleneck -> LoRA -> IA3 (its prefix rows
    # live in the KV cache): two or three of them in one launch, one alone
    # on its own route; one with none of these leaves (a prefix-only
    # bank_spec) leaves x as it is
    impl = cfg.xpeft.kernel_impl
    if sum(k in masks_l for k in ("a_hat", "lora_a", "ia3_s")) >= 2:
        return ops.hetero_adapter(x, masks_l,
                                  activation=cfg.xpeft.adapter_activation,
                                  impl=impl)
    if "a_hat" in masks_l:
        x = ops.fused_adapter(x, masks_l["a_hat"], masks_l["b_hat"],
                              masks_l["ln_scale"], masks_l["ln_bias"],
                              activation=cfg.xpeft.adapter_activation,
                              impl=impl)
    if "lora_a" in masks_l:
        x = ops.lora_adapter(x, masks_l["lora_a"], masks_l["lora_b"],
                             impl=impl)
    if "ia3_s" in masks_l:
        x = ops.ia3_apply(x, masks_l["ia3_s"], impl=impl)
    return x


def _decode_fused_route(cfg, masks, use_cache: bool, Tt: int):
    """Static eligibility of the decode megakernel: returns the adapter
    route ("none" | "bf16" | "int8" | "int4") or None for the composed
    path. Only the T=1 cached full-attention decode step qualifies; the
    on-the-fly mask routes (w_a / idx_a) keep the composed path — the
    megakernel fuses admission-time aggregated records only."""
    if not (cfg.decode_fused and use_cache and Tt == 1
            and cfg.block_pattern == "attn" and not cfg.moe
            and cfg.attn_type == "full" and cfg.causal):
        return None
    if masks is None or not cfg.xpeft.enabled:
        return "none"
    if any(key in masks for key in ("lora_a", "lora_b", "ia3_s",
                                    "prefix_skip")):
        return None  # heterogeneous entries take the composed per-type path
    if "a_q" in masks:
        return cfg.xpeft.bank_quant \
            if cfg.xpeft.bank_quant in ("int8", "int4") else None
    if "a_hat" in masks:
        return "bf16"
    return None


def _decode_fused_apply(block, x, masks_l, cfg, *, positions, cache_l,
                        cache_pos, route):
    """Megakernel step: one launch for norm/attn/MLP/adapter, then the K/V
    row scatter OUTSIDE the kernel, in place, with the cache write's own
    semantics (a scalar position clamps, per-slot positions past the end
    are dropped). The kernel reads the cache before the scatter."""
    y, k_rows, v_rows = ops.decode_block_fused(
        x, positions[:, 0].contiguous(), block, cache_l["k"], cache_l["v"],
        masks_l, norm=cfg.norm, qkv_bias=cfg.qkv_bias,
        use_rope=cfg.pos == "rope", theta=cfg.rope_theta,
        cap=cfg.logit_softcap, mlp_type=cfg.mlp_type, act_name=cfg.act,
        adapter=route, adapter_act=cfg.xpeft.adapter_activation,
        impl=cfg.xpeft.kernel_impl)
    ATT.write_cache(cache_l["k"], k_rows[:, None], cache_pos)
    ATT.write_cache(cache_l["v"], v_rows[:, None], cache_pos)
    return y


def _attn_block_apply(block, x, cfg, *, positions, cache_l, cache_pos,
                      is_global=True, front_skip=None, extra_kv=None):
    h = norm_apply(x, block["n1"], cfg.norm)
    h, _ = ATT.attention(block["attn"], h, positions=positions, cfg=cfg,
                         cache=cache_l, cache_pos=cache_pos,
                         is_global=is_global, front_skip=front_skip,
                         extra_kv=extra_kv)
    x = x + h
    h = norm_apply(x, block["n2"], cfg.norm)
    if cfg.moe:
        h, aux = MOE.moe_apply(block["moe"], h, cfg)
        return x + h, aux
    return x + MLP.mlp_apply(block["mlp"], h, cfg), None


def _recurrent_layer(block, x, cfg, cache_l):
    """One rwkv or mamba layer; its new state goes into the layer's cache
    leaves in place, after the block has read the old one."""
    if cfg.block_pattern == "rwkv":
        x, new = RK.rwkv_block(block["rwkv"], x, cfg,
                               {"n1": block["n1"], "n2": block["n2"]},
                               cache_l)
    else:
        x, new = MB.mamba_block(block["mamba"], x, cfg, {"n1": block["n1"]},
                                cache_l)
    if cache_l is not None:
        for k, v in new.items():
            cache_l[k].copy_(v)
    return x


# JAX's ``dots_with_no_batch_dims_saveable``: the outputs of products with
# no batch dims are kept, everything else is recomputed. ``torch.einsum``
# lowers a product with no batch dims to a ``bmm`` of batch 1
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def saves_dot(func, args) -> bool:
    """Whether the ``"dots"`` policy keeps this op's output: a product
    with no batch dims (``mm``, ``addmm``, or einsum's ``bmm`` of batch
    1)."""
    if func in _DOTS:
        return True
    if func in _BATCHED_DOTS:
        a = args[1] if func == torch.ops.aten.baddbmm.default else args[0]
        return a.shape[0] == 1
    return False


def _dots_policy(ctx, func, *args, **kwargs):
    CP = torch.utils.checkpoint.CheckpointPolicy
    return CP.MUST_SAVE if saves_dot(func, args) else CP.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def _remat_kw(cfg, blocks, bank):
    """How a layer runs under autograd without a cache: None (kept whole),
    or the ``checkpoint`` arguments that recompute it in the backward.
    ``cfg.remat`` as JAX's ``_remat``: "full" recomputes the whole layer,
    "dots" keeps the products with no batch dims (``_dots_policy``),
    "none" keeps everything. A layer holding sharded leaves always runs
    as a whole checkpoint: the backward gathers its weights again instead
    of keeping every gathered layer alive, so a rank's peak holds one
    whole layer."""
    leaves = [v for sub in blocks.values() for v in sub.values()] \
        + list((bank or {}).values())
    # no early stop: the backward recomputes the layer's whole forward,
    # one more forward a step, the cost the op counter states exactly
    whole = {"early_stop": False}
    if any(isinstance(v, SH.Sharded) for v in leaves):
        return whole
    if cfg.remat == "none":
        return None
    if cfg.remat == "dots":
        return dict(whole, context_fn=_dots_context)
    return whole


def embed_tokens(params, tokens, cfg):
    """The token rows [B, T, d], times gemma's embedding scale: sqrt(d) in
    fp32, rounded to the rows' dtype, one product in that dtype (a Python
    float would multiply in fp32 by the unrounded scale)."""
    x = SH.rows(params["embed"], tokens.long())
    if cfg.embed_scale:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32))
        x = x * scale.to(device=x.device, dtype=x.dtype)
    return x


def forward(params, tokens, cfg, *, prefix_embeds=None, profile_masks=None,
            cache=None, cache_pos=0, positions=None):
    """tokens [B,T] -> (hidden [B,P+T,d], cache, aux_loss).

    prefix_embeds: optional [B,P,d] frontend rows (vision patches, audio
    frames), cast to x's dtype and put in front of the (scaled) token
    rows; the positions then run over all P + T rows from ``cache_pos``.
    profile_masks: {"a_hat" [B,L,d,b], "b_hat" [B,L,b,d], "ln_scale",
    "ln_bias" [B,L,b]} (admission-time aggregated adapters), their
    quantized form {"a_q", "a_scale", "b_q", "b_scale", "ln_scale",
    "ln_bias"}, a heterogeneous entry (any of those bottleneck leaves,
    "lora_a"/"lora_b", "ia3_s" [B,L,d], "prefix_skip" [B,L] int32),
    on-the-fly mask weights {"w_a", "w_b" [B,L,N], "ln_scale", "ln_bias"}
    (plus "idx_a", "idx_b" [B,L,k] for the k-sparse form, w_* then
    [B,L,k]), or None. With a cache, each layer's "prefix_skip" masks that many key
    slots at the front of the cache (the hydrated prefix rows).
    cache: from ``init_cache``, written IN PLACE at ``cache_pos`` (a
    scalar, or [B] per-slot offsets) and returned; None runs uncached.
    Learned positions (``cfg.pos == "learned"``) add ``pos_embed``'s rows
    from a scalar ``cache_pos`` on (the start clamped so T rows fit, as
    ``lax.dynamic_slice`` clamps), or each slot's ``positions``."""
    check_supported(cfg)
    B = tokens.shape[0]
    x = embed_tokens(params, tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    T = x.shape[1]
    if positions is None:
        if torch.is_tensor(cache_pos) and cache_pos.ndim == 1:
            positions = cache_pos[:, None] + torch.arange(
                T, dtype=torch.int32, device=x.device)
        else:
            positions = (int(cache_pos) + torch.arange(
                T, dtype=torch.int32, device=x.device))[None].expand(B, T)
        if cache is None and profile_masks is not None \
                and cfg.xpeft.enabled and cfg.xpeft.has_prefix \
                and "w_a" in profile_masks:
            # the dense prefix path: prefix KV rows sit at positions [0, P),
            # so the prompt's RoPE phase starts at P, as serving writes the
            # prompt at cache_pos P behind the hydrated rows. Per example:
            # a profile whose masks never touch the prefix segment keeps
            # bare positions (RoPE is only relatively shift-invariant, so a
            # blanket offset would break zero mask == bare bitwise).
            wsum = torch.zeros((B,), dtype=torch.float32, device=x.device)
            for typ, off, cnt in cfg.xpeft.segments():
                if typ == "prefix":
                    wsum = wsum \
                        + profile_masks["w_a"][:, :, off:off + cnt].sum(
                            (1, 2)) \
                        + profile_masks["w_b"][:, :, off:off + cnt].sum(
                            (1, 2))
            offs = torch.where(wsum > 0, cfg.xpeft.prefix_tokens, 0)
            positions = positions + offs.to(positions.dtype)[:, None]
    if cfg.pos == "learned":
        pe = params["pos_embed"]
        if torch.is_tensor(cache_pos) and cache_pos.ndim == 1:
            x = x + pe[positions.long()]
        else:
            start = min(max(int(cache_pos), 0), pe.shape[0] - T)
            x = x + pe[start:start + T][None]
    blocks = params["blocks"]
    bank = params.get("xpeft_bank")
    fused_route = _decode_fused_route(cfg, profile_masks, cache is not None,
                                      T)
    meta = layer_meta(cfg)
    recurrent = cfg.block_pattern != "attn"
    # JAX's condition for the expert-parallel MoE path: its experts stay
    # this rank's blocks, every other sharded leaf is gathered whole
    ep = MOE.ep_mesh(cfg) is not None
    # the mesh context, for a layer recomputed on an autograd thread
    mesh_ctx = CTX.current()

    def run_layer(x, l):
        """Layer l on x: (x, the layer's MoE aux or None)."""
        with CTX.restored(mesh_ctx):
            return layer_body(x, l)

    def layer_body(x, l):
        # a mesh's model-sharded leaves (``SH.Sharded``) are gathered
        # whole here, one layer at a time, so the layer code and its
        # kernels run as on one device
        block = {name: {k: SH.layer_block(v, l) if ep and name == "moe"
                        else SH.layer(v, l) for k, v in sub.items()}
                 for name, sub in blocks.items()}
        cache_l = None if cache is None else \
            {k: v[l] for k, v in cache.items()
             if k not in ("attn_k", "attn_v")}
        masks_l = None if profile_masks is None else \
            {k: v[:, l] for k, v in profile_masks.items()}
        # the bank's layer slice, for the on-the-fly mask routes only
        bank_l = {k: SH.layer(v, l) for k, v in bank.items()} \
            if bank is not None and masks_l is not None \
            and "w_a" in masks_l else None
        if recurrent:
            x = _recurrent_layer(block, x, cfg, cache_l)
            x = _xpeft_apply(x, bank_l, masks_l, cfg)
            if cfg.block_pattern == "zamba" \
                    and (l + 1) % cfg.shared_attn_every == 0:
                # the shared block after each whole group (none after the
                # remainder: 38 = 6 * 6 + 2), on its own K/V slice
                g = (l + 1) // cfg.shared_attn_every - 1
                x, _ = _attn_block_apply(
                    SH.whole_tree(params["shared_attn"]), x,
                    shared_attn_cfg(cfg),
                    positions=positions,
                    cache_l=None if cache is None else
                    {"k": cache["attn_k"][g], "v": cache["attn_v"][g]},
                    cache_pos=cache_pos)
            return x, None
        if fused_route is not None:
            # the block and the adapter in one launch: no _xpeft_apply
            return _decode_fused_apply(block, x, masks_l, cfg,
                                       positions=positions, cache_l=cache_l,
                                       cache_pos=cache_pos,
                                       route=fused_route), None
        front_skip = extra_kv = None
        if cache is not None and masks_l is not None \
                and "prefix_skip" in masks_l:
            front_skip = masks_l["prefix_skip"]
        if cache is None and bank_l is not None and cfg.xpeft.enabled \
                and cfg.xpeft.is_hetero:
            # the dense prefix path: this layer's per-example prefix rows
            # (None when the spec has no prefix segment); serving instead
            # hydrates them into the KV cache at admission
            extra_kv = XP.prefix_rows_dense_layer(
                bank_l, masks_l["w_a"], masks_l["w_b"], cfg.xpeft,
                cfg.num_kv_heads, cfg.head_dim)
        x, aux = _attn_block_apply(block, x, cfg, positions=positions,
                                   cache_l=cache_l, cache_pos=cache_pos,
                                   is_global=meta[l], front_skip=front_skip,
                                   extra_kv=extra_kv)
        return _xpeft_apply(x, bank_l, masks_l, cfg), aux

    remat = _remat_kw(cfg, blocks, bank) \
        if torch.is_grad_enabled() and cache is None else None
    auxs = []
    for l in range(cfg.num_layers):
        x, aux = run_layer(x, l) if remat is None else \
            checkpoint(run_layer, x, l, use_reentrant=False, **remat)
        if aux is not None:
            auxs.append(aux)
    x = norm_apply(x, params["final_norm"], cfg.norm)
    # JAX's jnp.mean over the layers' aux (0 for a dense block)
    aux = torch.stack(auxs).mean() if auxs else \
        torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cache, aux


# ----------------------------------------------------------------------------
# Heads
# ----------------------------------------------------------------------------

def lm_logits(params, hidden, cfg):
    if cfg.tie_embeddings:
        logits = hidden @ SH.whole(params["embed"]).T
    else:
        logits = hidden @ SH.whole(params["lm_head"])
    return softcap(logits.float(), cfg.logit_softcap)


def cls_pooled(params, hidden):
    """The pooler: tanh of the first token's ([CLS]) hidden state through
    ``pool_w``/``pool_b``, in fp32 -> [B, d]."""
    cls = params["cls"]
    return torch.tanh(hidden[:, 0, :].float() @ cls["pool_w"]
                      + cls["pool_b"])


def cls_logits(params, hidden, cfg, head_override=None):
    """Encoder classification: the pooled first token ([CLS]) -> labels,
    in fp32. ``head_override`` replaces the shared head: a per-example
    head {"head_w" [B, d, C], "head_b" [B, C]} (the per-profile heads of
    X-PEFT training and serving) goes through the einsum; the shared
    head itself (``params["cls"]``, tested by identity as JAX does) or
    None takes the plain product."""
    cls = params["cls"]
    pooled = cls_pooled(params, hidden)
    head = head_override if head_override is not None else cls
    if head is cls:
        return pooled @ head["head_w"] + head["head_b"]
    return torch.einsum("bd,bdc->bc", pooled, head["head_w"]) \
        + head["head_b"]
