"""Train steps, the port of ``repro.train.steps``.

Modes (paper §4 baselines, one mechanism):
- "xpeft":     trainable = the per-profile mask table (+ per-profile heads
               for encoders). THE paper workload: multi-profile mask
               training against a frozen PLM and a frozen shared adapter
               bank, k-hot masks by straight-through Gumbel top-k.
- "adapter":   the single-adapter baseline: one fresh bottleneck adapter
               (a bank of N=1 under a fixed mask) and its LN (+ a head),
               PLM frozen.
- "head_only": the head-only baseline: the encoder's classification head
               on the bare PLM (no adapter bank).
- "full":      full training of every weight (the non-paper path).

A config with ``num_labels`` (the encoder, ``bert-base-xpeft``) trains the
classification objective (``cls_loss``: mean CE of the pooled-[CLS]
logits, plus accuracy); any other trains the LM objective (sequence-
chunked next-token CE).

The state is JAX's tree, ``{"frozen", "trainable", "opt"}``. The trainable
subtree is separate from the frozen params, and the frozen tensors never
require grad, so autograd computes no weight gradient for them, as XLA
drops them in JAX. Gradients come from autograd through plain torch ops:
no hand-written kernel has a backward, and ``kernels/ops.py`` refuses an
input that requires grad.

``make_gang_step`` is the slot-packed step of the profile lifecycle: one
update trains every active roster slot on its own micro-batch
(``train/roster.py``, ``train/onboarding.py``).

On a mesh (``mesh=``, a ``torch.distributed`` ``DeviceMesh``; the port
has no GSPMD, so every tensor is placed explicitly):

- the gang step takes the roster as "data" rows (``Roster.place``) with
  the frozen PLM whole on every rank; each rank runs its slots'
  micro-batches, row clips, row AdamW and EMAs, so nothing of a slot
  crosses ranks and the update is bitwise the one-device update. Every
  rank draws the step's whole Gumbel noise from its generator (the same
  state on every rank) and keeps its slots' rows. Only the metric sums
  are gathered.
- the plain step takes the frozen tree as ``Sharded`` blocks
  (``shard_train_state``: ``param_specs`` without FSDP), gathered a layer at a time in the forward and again in
  the backward (``models/model.py``), the batch's rows over the batch
  axes, the noise drawn whole and sliced. The trainables' gradients and
  the metrics are the mean of the ranks' local means, gathered and summed
  in rank order; clipping and AdamW then run identically on every rank.
  Within tolerance of one device: the mean of means rounds otherwise.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import masks as M
from repro_torch.core import xpeft as XP
from repro_torch.core.adapters import init_adapter_bank
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as MDL
from repro_torch.optim import (adamw_init, adamw_update, adamw_update_rows,
                               clip_by_global_norm, clip_by_row_norm)
from repro_torch.optim.adamw import _bcast_rows
from repro_torch.utils import generator, resolve_device
from repro_torch.utils.tree import map_with_path, merge_trees, tree_leaves, \
    tree_map, tree_paths

MODES = ("xpeft", "adapter", "head_only", "full")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")


# ----------------------------------------------------------------------------
# Trainable init per mode
# ----------------------------------------------------------------------------

def _head(cfg, lead, gen, device) -> dict:
    """A classification head, JAX's init: head_w 0.02 x N(0, 1) [*lead, d,
    C], head_b zeros [*lead, C], fp32."""
    C = cfg.num_labels
    return {"head_w": 0.02 * torch.randn(
                lead + (cfg.d_model, C), generator=gen, device=device,
                dtype=torch.float32),
            "head_b": torch.zeros(lead + (C,), dtype=torch.float32,
                                  device=device)}


def init_xpeft_trainable(cfg, *, seed: int = 0, device=None) -> dict:
    """The per-profile mask table, [max_profiles, ...] rows drawn from
    ``seed``; with ``num_labels``, per-profile heads [max_profiles, d, C]
    drawn from ``seed + 1``."""
    device = resolve_device(device)
    out = {"table": XP.init_profile_table(cfg, seed=seed, device=device)}
    if cfg.num_labels:
        gen = generator(device, seed + 1)
        out["heads"] = _head(cfg, (cfg.xpeft.max_profiles,), gen, device)
    return out


def init_adapter_trainable(cfg, *, seed: int = 0, device=None) -> dict:
    """single_adapter baseline: one adapter (a bank of N=1) + its LN, and
    with ``num_labels`` a head, drawn after the bank."""
    device = resolve_device(device)
    xp = cfg.xpeft
    gen = generator(device, seed)
    shape = (cfg.num_layers, xp.bottleneck)
    out = {
        "bank": init_adapter_bank(cfg.num_layers, 1, cfg.d_model,
                                  xp.bottleneck, MDL.torch_dtype(cfg.dtype),
                                  generator=gen, device=device),
        "ln_scale": torch.ones(shape, dtype=torch.float32, device=device),
        "ln_bias": torch.zeros(shape, dtype=torch.float32, device=device),
    }
    if cfg.num_labels:
        out["head"] = _head(cfg, (), gen, device)
    return out


def init_head_trainable(cfg, *, seed: int = 0, device=None) -> dict:
    """head_only baseline: one head [d, num_labels]."""
    device = resolve_device(device)
    gen = generator(device, seed)
    return {"head": _head(cfg, (), gen, device)}


def init_trainable(cfg, mode: str, *, seed: int = 0, device=None) -> dict:
    _check_mode(mode)
    init = {"xpeft": init_xpeft_trainable,
            "adapter": init_adapter_trainable,
            "head_only": init_head_trainable}.get(mode)
    if init is None:
        raise ValueError(f"mode {mode!r} has no separate trainable init")
    return init(cfg, seed=seed, device=device)


def init_train_state(cfg, mode: str = "xpeft", *, seed: int = 0,
                     device=None) -> dict:
    """{"frozen", "trainable", "opt"}: the frozen LM from ``seed``, the
    mode's trainables from ``seed + 1``; ``full`` trains the LM itself."""
    _check_mode(mode)
    frozen = MDL.init_lm(cfg, seed=seed, device=device)
    if mode == "full":
        return {"frozen": {}, "trainable": frozen, "opt": adamw_init(frozen)}
    trainable = init_trainable(cfg, mode, seed=seed + 1, device=device)
    return {"frozen": frozen, "trainable": trainable,
            "opt": adamw_init(trainable)}


def shard_train_state(state: dict, mesh) -> dict:
    """A plain train state for ``make_train_step(mesh=)``: the frozen tree
    held as this rank's ``Sharded`` blocks under ``param_specs`` with FSDP
    off (JAX's rules: "model" blocks, and the experts' ff dim over
    "data"), the trainables and moments whole on every rank."""
    frozen = state["frozen"]
    specs = SH.param_specs(frozen, mesh, fsdp=False)
    return dict(state, frozen=SH.place(frozen, specs, mesh))


# ----------------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------------

def lm_loss(logits, labels):
    """Mean next-token CE. logits [B,T,V] fp32, labels [B,T]."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def lm_loss_chunked(params, hidden, labels, cfg, chunk: int = 512):
    """CE without materializing [B,T,V] at once: the sequence in chunks of
    ``chunk`` tokens, each chunk's logits recomputed in the backward
    (``torch.utils.checkpoint``, where JAX checkpoints the scan body).
    T <= chunk, or T not a multiple of it, takes ``lm_loss`` whole."""
    B, T, _ = hidden.shape
    if T <= chunk or T % chunk != 0:
        return lm_loss(MDL.lm_logits(params, hidden, cfg), labels)

    def body(h, lab):
        logits = MDL.lm_logits(params, h, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return torch.sum(lse - gold)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T, chunk):
        total = total + checkpoint(body, hidden[:, i:i + chunk],
                                   labels[:, i:i + chunk],
                                   use_reentrant=False)
    return total / (B * T)


def cls_loss(logits, labels):
    """(mean CE, accuracy) of classification logits [B, C] fp32 against
    labels [B]."""
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return torch.mean(lse - gold), acc


# ----------------------------------------------------------------------------
# Forward under each mode
# ----------------------------------------------------------------------------

def _noise_kw(rng) -> dict:
    """A ``torch.Generator`` draws the Gumbel noise; a (noise_a, noise_b)
    pair is used as given; None adds none."""
    if isinstance(rng, torch.Generator):
        return {"generator": rng}
    return {"noise": rng}


def _forward_mode(frozen, trainable, batch, cfg, mode, rng, training=True):
    """(hidden [B,P+T,d], aux, head_override, params) of the batch under
    ``mode`` (P: the batch's ``prefix_embeds`` rows, if any):
    head_override is the batch's per-example heads (xpeft), the one
    trainable head (adapter, head_only) or None (the shared head, or no
    classification)."""
    _check_mode(mode)
    tokens = batch["tokens"]
    masks = None
    head_override = None
    params = frozen
    if mode == "xpeft":
        prof = XP.gather_profiles(trainable["table"], batch["profile_ids"])
        w_a, w_b = XP.profile_mask_weights(prof, cfg.xpeft,
                                           training=training,
                                           **_noise_kw(rng))
        masks = {"w_a": w_a, "w_b": w_b, "ln_scale": prof["ln_scale"],
                 "ln_bias": prof["ln_bias"]}
        if cfg.num_labels:
            head_override = XP.gather_profiles(trainable["heads"],
                                               batch["profile_ids"])
    elif mode == "adapter":
        B = tokens.shape[0]
        ones = torch.ones((B, cfg.num_layers, 1), dtype=torch.float32,
                          device=tokens.device)
        masks = {"w_a": ones, "w_b": ones,
                 "ln_scale": trainable["ln_scale"].expand(
                     (B,) + tuple(trainable["ln_scale"].shape)),
                 "ln_bias": trainable["ln_bias"].expand(
                     (B,) + tuple(trainable["ln_bias"].shape))}
        params = merge_trees(frozen, {"xpeft_bank": trainable["bank"]})
        if cfg.num_labels:
            head_override = trainable["head"]
    elif mode == "head_only":
        params = {k: v for k, v in frozen.items() if k != "xpeft_bank"}
        head_override = trainable["head"]
        cfg = cfg.with_xpeft(enabled=False)
    else:
        params = trainable
    hidden, _, aux = MDL.forward(params, tokens, cfg,
                                 prefix_embeds=batch.get("prefix_embeds"),
                                 profile_masks=masks)
    return hidden, aux, head_override, params


def loss_for_batch(frozen, trainable, batch, cfg, mode, rng, training=True):
    """(total loss, metrics) of one batch plus 0.01 x the auxiliary loss:
    with ``num_labels`` the classification objective (``cls_loss``;
    metrics carry "accuracy"), else the LM objective, sequence-chunked
    CE."""
    hidden, aux, head, params = _forward_mode(frozen, trainable, batch, cfg,
                                              mode, rng, training)
    metrics = {}
    if cfg.num_labels:
        if head is not None and head["head_w"].ndim == 3:
            logits = MDL.cls_logits(params, hidden, cfg, head)
        elif head is not None:
            # one trainable head on the frozen pooler
            logits = MDL.cls_pooled(params, hidden) @ head["head_w"] \
                + head["head_b"]
        else:
            logits = MDL.cls_logits(params, hidden, cfg)
        loss, metrics["accuracy"] = cls_loss(logits, batch["labels"])
    else:
        # the LM loss over the token rows, behind a frontend's P prefix rows
        prefix = batch.get("prefix_embeds")
        P = 0 if prefix is None else prefix.shape[1]
        loss = lm_loss_chunked(params, hidden[:, P:], batch["labels"], cfg)
    metrics["loss"] = loss
    metrics["aux_loss"] = aux
    return loss + 0.01 * aux, metrics


# ----------------------------------------------------------------------------
# Step factory
# ----------------------------------------------------------------------------

def _rows_per_example(t, m: int):
    """[S, ...] -> [S * m, ...], each slot's row repeated for its m
    examples: JAX's ``t[repeat(arange(S), m)]`` as a broadcast, whose
    backward is a plain sum over m (an index gather's backward would
    scatter-add, with float atomics on the card)."""
    return t.unsqueeze(1).expand((t.shape[0], m) + tuple(t.shape[1:])) \
        .reshape((t.shape[0] * m,) + tuple(t.shape[1:]))


def gang_loss_and_grads(frozen, rstate, batch, cfg, rng):
    """The gang step's forward and gradient: (grads of the roster's
    trainables, slot_loss [S], slot_acc [S]) for a batch of [S, m, ...]
    tensors. The loss is the SUM over active slots of each slot's mean
    loss (never normalized by the active count), so a slot's gradient is
    independent of which other slots are occupied. Per-example losses are
    ``cross_entropy``'s, whose backward writes each row's target once (no
    scatter-add)."""
    S, m = batch["tokens"].shape[:2]
    toks = batch["tokens"].reshape(S * m, -1)
    active = rstate["active"]
    trainable = tree_map(lambda p: p.detach().requires_grad_(True),
                         rstate["trainable"])
    prof = {k: _rows_per_example(v, m)
            for k, v in trainable["table"].items()}
    w_a, w_b = XP.profile_mask_weights(prof, cfg.xpeft, training=True,
                                       **_noise_kw(rng))
    pmasks = {"w_a": w_a, "w_b": w_b, "ln_scale": prof["ln_scale"],
              "ln_bias": prof["ln_bias"]}
    hidden, _, _ = MDL.forward(frozen, toks, cfg, profile_masks=pmasks)
    if cfg.num_labels:
        head = {k: _rows_per_example(v, m)
                for k, v in trainable["heads"].items()}
        logits = MDL.cls_logits(frozen, hidden, cfg, head)
        labels = batch["labels"].reshape(S * m).long()
        per_ex = F.cross_entropy(logits, labels, reduction="none")
        slot_acc = (torch.argmax(logits, -1) == labels).float() \
            .reshape(S, m).mean(dim=1)
    else:
        logits = MDL.lm_logits(frozen, hidden, cfg)
        labels = batch["labels"].reshape(-1).long()
        per_ex = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels, reduction="none") \
            .reshape(S * m, -1).mean(dim=-1)
        slot_acc = torch.zeros((S,), dtype=torch.float32,
                               device=per_ex.device)
    slot_loss = per_ex.reshape(S, m).mean(dim=1)
    total = torch.sum(torch.where(active, slot_loss, 0.0))
    total.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), trainable)
    return grads, slot_loss.detach(), slot_acc.detach()


def _draws(rng, cfg, rows: int, dev):
    """The step's Gumbel noise as a (noise_a, noise_b) pair of [rows, L, N]:
    a generator draws it as the one-device forward would (A's then B's,
    and nothing where the masks take no noise), a given pair is used as
    it is, None stays None."""
    xp = cfg.xpeft
    if isinstance(rng, torch.Generator):
        if xp.mask_type != "hard" or xp.nu <= 0:
            return None
        shape = (rows, cfg.num_layers, xp.num_adapters)
        return tuple(M.gumbel(shape, generator=rng, device=dev)
                     for _ in range(2))
    return rng


def make_gang_step(cfg, *, lr=1e-3, weight_decay=0.0, clip_norm: float = 1.0,
                   ema_decay: float = 0.9, mesh=None, fault_plan=None):
    """Slot-packed gang step for the onboarding roster.

    One update trains every ACTIVE slot on its own micro-batch:
    ``batch["tokens"]`` is [S, m, T] (row s belongs to slot s), labels
    [S, m] for classification or [S, m, T] for the LM objective (tensors
    or numpy arrays, moved to the roster's device). Slot isolation is
    exact and bitwise: the loss sums per-slot means
    (``gang_loss_and_grads``), grads are clipped per slot row
    (``clip_by_row_norm``), and ``adamw_update_rows`` leaves inactive
    rows' params AND moments untouched.

    Finite guard (always on): a slot whose loss or grads come back
    non-finite is masked out of the update exactly like an inactive one;
    its EMAs and ``slot_step`` freeze and its ``nonfinite`` counter
    increments (the onboarding strike counter). A ``fault_plan`` with
    ``poison_slots`` overwrites the selected slots' loss and grads with
    NaN AFTER the gradient, the seam that proves the guard (by global
    slot id on a mesh).

    Everything stays on the device: the EMAs update there, and the
    metrics come back as device tensors (no host sync inside the step).
    The step writes the new roster IN PLACE into the state's tensors,
    whose storage never changes, and returns the same state dict.

    ``rng``: a ``torch.Generator`` that draws the step's Gumbel noise of
    shape [S * m, L, N] (A's then B's), a (noise_a, noise_b) pair of such
    draws, or None (no noise). Returns ``step({"frozen", "roster"},
    batch, rng) -> (state, metrics)``.

    With a ``mesh`` the roster is held as its "data" rows (``Roster.place``
    on that mesh): each rank takes its slots' rows of the batch and of the
    whole noise, and only the metric sums cross ranks (gathered, summed in
    rank order); a roster whose slots do not split stays whole and every
    rank steps all of it."""

    def step(state, batch, rng):
        frozen, rstate = state["frozen"], state["roster"]
        if mesh is not None and SH.sharding_of(rstate["active"]) is None \
                and SH.leading_axis_specs(rstate["active"], mesh)[0]:
            raise ValueError("make_gang_step(mesh=): the roster's slots "
                             "split over the mesh; hold it there first "
                             "(Roster.place)")
        loc = SH.local_tree(rstate)
        dev = loc["active"].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        S, m = batch["tokens"].shape[:2]
        lo, n = SH.row_range(rstate["active"])
        if n != S:
            # this rank's slots: their rows of the batch and of the noise
            # every rank draws whole
            batch = {k: v[lo:lo + n] for k, v in batch.items()}
            rng = _draws(rng, cfg, S * m, dev)
            if rng is not None:
                rng = tuple(r[lo * m:(lo + n) * m] for r in rng)
        active = loc["active"]
        grads, slot_loss, slot_acc = gang_loss_and_grads(
            frozen, loc, batch, cfg, rng)
        with torch.no_grad():
            if fault_plan is not None and fault_plan.poisons_gang():
                # the seam, AFTER the gradient: healthy slots' gradient
                # computation is unchanged by the injection
                pmask = fault_plan.gang_poison_mask(loc["slot_step"], S,
                                                    first=lo)
                grads = tree_map(lambda g: torch.where(
                    _bcast_rows(pmask, g), torch.nan, g), grads)
                slot_loss = torch.where(pmask, torch.nan, slot_loss)
            # the finite guard: a poisoned slot is treated as a parked one
            finite = torch.isfinite(slot_loss)
            for g in tree_leaves(grads):
                finite = finite & torch.isfinite(g).reshape(n, -1).all(dim=1)
            ok = active & finite
            grads, gnorm = clip_by_row_norm(grads, clip_norm)
            new_params, new_opt = adamw_update_rows(
                grads, loc["opt"], loc["trainable"], ok, lr=lr,
                weight_decay=weight_decay)
            d = ema_decay

            def ema(old, x):
                return torch.where(ok, d * old + (1 - d) * x, old)
            okf = ok.float()
            bad = (active & ~finite)
            new = {"trainable": new_params, "opt": new_opt,
                   "slot_step": loc["slot_step"] + ok.to(torch.int32),
                   "ema_loss": ema(loc["ema_loss"], slot_loss),
                   "ema_acc": ema(loc["ema_acc"], slot_acc),
                   "ema_count": loc["ema_count"] + ok.to(torch.int32),
                   "nonfinite": loc["nonfinite"] + bad.to(torch.int32)}
            tree_map(lambda t, n: t.copy_(n),
                     {k: loc[k] for k in new}, new)
            sums = torch.stack([
                torch.where(ok, slot_loss, 0.0).sum(),
                torch.where(ok, gnorm, 0.0).sum(),
                torch.where(ok, slot_acc, 0.0).sum(),
                okf.sum(), active.float().sum(), bad.float().sum()])
            if n != S:
                act = rstate["active"]
                sums = SH.rank_sum(sums, act.mesh, act.spec[0])
            n_ok = torch.clamp(sums[3], min=1.0)
            metrics = {"loss": sums[0] / n_ok, "grad_norm": sums[1] / n_ok,
                       "active_slots": sums[4], "nonfinite_slots": sums[5]}
            if cfg.num_labels:
                metrics["accuracy"] = sums[2] / n_ok
        return state, metrics

    return step


def grads_for_batch(frozen, trainable, batch, cfg, mode, rng):
    """(grads in the trainables' dtypes, zeros where a leaf is unused;
    metrics) of one batch (tensors on the trainables' device), by
    autograd: ``jax.value_and_grad`` of ``loss_for_batch``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), trainable)
    total, metrics = loss_for_batch(frozen, leaves, batch, cfg, mode, rng)
    if total.requires_grad:
        # else no trainable reaches the loss (head_only under the LM
        # objective): every gradient is zero, as jax.grad gives
        total.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    return grads, {k: v.detach() for k, v in metrics.items()}


def _batch_share(mesh):
    """(this rank's index, the rank count, the axes) of the batch axes
    (pod, data) with more than one rank: how ``batch_specs`` lays a
    batch's leading dim out."""
    sizes = SH.axis_sizes(mesh)
    axes = tuple(a for a in SH.batch_axes(mesh) if sizes[a] > 1)
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + mesh.get_local_rank(a), n * sizes[a]
    return idx, n, axes


def make_train_step(cfg, mode: str = "xpeft", *, lr=1e-3, weight_decay=0.0,
                    clip_norm: float = 1.0, accum: int = 1, mesh=None):
    """Returns ``step(state, batch, rng) -> (state, metrics)``.

    ``batch``: {"tokens" [B, T], "labels" ([B, T] next tokens, or [B]
    classes with ``num_labels``), "profile_ids" [B]}, tensors or
    numpy arrays (moved to the trainables' device). ``rng``: a
    ``torch.Generator`` that draws the step's Gumbel noise, a
    (noise_a, noise_b) pair of standard Gumbel draws of the (micro-)batch's
    [B / accum, L, N] mask shape, or None (no noise).

    With ``accum > 1`` the batch splits into ``accum`` micro-batches along
    its leading axis, and each micro-batch sees the SAME noise (JAX passes
    one rng to every micro-batch); gradients sum in fp32 and are divided
    by ``accum`` (metrics, accuracy included, likewise). Clipping is
    global, after accumulation.

    With a ``mesh`` (the state from ``shard_train_state``) ``batch`` is
    this rank's rows of the global batch (its block over the batch axes,
    as a ``ShardedLoader`` with ``host_id`` the rank's batch index gives
    it), global row r taking noise row r mod (B / accum) of the whole
    draw, in ``accum`` micro-batches of its own; its gradients and
    metrics (local means) are averaged over the batch axes in rank order,
    so every rank clips and updates identically. The forward runs under
    ``mesh_context`` (a MoE layer takes the expert-parallel path)."""
    _check_mode(mode)

    def step(state, batch, rng):
        frozen, trainable = state["frozen"], state["trainable"]
        dev = tree_leaves(trainable)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        n = batch["tokens"].shape[0]
        idx, ranks, axes = (0, 1, ()) if mesh is None else _batch_share(mesh)
        B, mb = n * ranks, n // accum
        if isinstance(rng, torch.Generator) and mode == "xpeft":
            # one draw per step, shared by every micro-batch
            rng = _draws(rng, cfg, B // accum, dev)

        def part_rng(i):
            if not axes or rng is None or isinstance(rng, torch.Generator):
                return rng
            # this micro-batch's global rows, each with its noise row
            rows = (idx * n + i * mb + torch.arange(mb, device=dev)) \
                % (B // accum)
            return tuple(torch.as_tensor(r).to(dev)[rows] for r in rng)

        with CTX.mesh_context(mesh) if mesh is not None \
                else contextlib.nullcontext():
            if accum > 1 or axes:
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), trainable)
                metrics = None
                for i in range(accum):
                    part = {k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()}
                    g, m = grads_for_batch(frozen, trainable, part, cfg,
                                           mode, part_rng(i))
                    grads = tree_map(torch.add, grads, g)
                    metrics = m if metrics is None else \
                        {k: metrics[k] + m[k] for k in m}
                grads = tree_map(lambda g: g / accum, grads)
                metrics = {k: v / accum for k, v in metrics.items()}
            else:
                grads, metrics = grads_for_batch(frozen, trainable, batch,
                                                 cfg, mode, rng)
        with torch.no_grad():
            if axes:
                grads, metrics = _mean_over(grads, metrics, mesh, axes)
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            new_params, new_opt = adamw_update(
                grads, state["opt"], trainable, lr=lr,
                weight_decay=weight_decay)
        metrics["grad_norm"] = gnorm
        return {"frozen": frozen, "trainable": new_params,
                "opt": new_opt}, metrics

    return step


def _mean_over(grads, metrics, mesh, axes):
    """The ranks' local means of the gradients and metrics averaged over
    ``axes`` (one gather a batch axis of them all as one fp32 vector,
    summed in rank order): identical on every rank."""
    leaves = tree_leaves(grads)
    keys = sorted(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in leaves]
                     + [metrics[k].reshape(1).float() for k in keys])
    for a in axes:
        flat = SH.rank_sum(flat, mesh, a) / SH.axis_sizes(mesh)[a]
    parts = torch.split(flat, [g.numel() for g in leaves] + [1] * len(keys))
    by_path = dict(zip(tree_paths(grads), parts))
    grads = map_with_path(
        lambda p, g: by_path[p].view(g.shape).to(g.dtype), grads)
    return grads, {k: v.view(()) for k, v in zip(keys, parts[len(leaves):])}
