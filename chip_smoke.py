"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases, in order; any failed check exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit; turns
             TF32 off for float32 matmuls and convolutions.
2. build   — builds (or loads) the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels — each hand-written kernel against its plain PyTorch version on
             the card at the shapes the serving path gives it, then timed
             beside its plain version, its bound and, where one PyTorch call
             computes the same function, that call: CUDA events, medians
             after warm-up, around CUDA-graph replays (inputs rotated past
             the L2, as decode and admission find them), the aggregation's
             eager calls printed beside. The aggregation (#1, #4) is held
             bitwise at every shape, padded rows as exact zeros, two calls
             bitwise equal. The fused adapter (#2) is checked at T=1, 5,
             16, 17 and 128 (bf16 and fp32; per-row, shared and layer-slice
             operands; the LoRA route; b 32, 64 and 128; two calls bitwise
             equal; clusters of 16 at d=7168, T=1 and d=6144, T=16, where
             the planner picks them) and timed at T=1, 16 and 128. #1-#4's
             times before their redesign are printed beside (log lines
             only). The decode
             megakernel is checked at qwen1.5-0.5b's layer widths, B=4 slots,
             S=128, positions [3, 0, 77, 130] (130 >= S: nothing substituted,
             the row dropped later), biases, norm scales and LN affines drawn
             at random, on routes none and bf16 and a GQA shape (KV=4), on
             a long cache (route bf16, S=2048, positions [2047, 0, 1000,
             1500]), and once at B=8 (its instantiation for 5 to 8 slots);
             its times before the redesign are printed beside (log only). The
             unbatched adapter (x [256, 1024]) and the one-profile aggregation
             (bank [256, 1024, 64], k=50) are checked and timed too. The
             quantized-bank kernels: the aggregation over int8 / int4 rows
             (both sides, P=96, k=50; bitwise, and each term bitwise with
             one-hot weights), the dequantizing fused adapter (#6, a
             cluster per tile and batch row as #2: B=4 on layer slices at
             T=1, 5, 16, 17 and 128, b 32, 64 and 128, fp32 x, clusters
             of 16 at d=7168 T=1 (int8) and d=6144 T=16 (int4), two calls
             bitwise equal; timed at T=1, 16 and, int8, 128) and the
             megakernel's routes int8/int4 (B=4 and once at B=8), each
             scheme at quant_group 32 and int4 once more at 16 (the
             aggregation also at 8, its per-byte scale path); all beside
             the shared csrc/dequant.cuh. #5's and #6's times before their
             redesign are printed beside (log lines only).
4. serve   — qwen1.5-0.5b at full published width with random weights:
             4 hard-mask profiles, 8 requests of 4-16 prompt tokens and 16
             new tokens on 4 slots (max_seq 128, sync_every 8), through the
             port's ServeEngine; both kernels' launch counters must move.
             The same requests are served again with kernel_impl="ref" (the
             plain versions); the prefill logits and the decode-step logits
             under teacher forcing (both runs fed the ref run's tokens) are
             compared, and every greedy token where the runs part is shown
             to be a flip that the logit difference explains. A decode step
             is timed on the host clock and profiled (torch.profiler) for
             the device time by kernel. Then the entry points of the
             unbatched adapter and the one-profile aggregation are driven
             over the 24 layers of an admitted profile. Last, the same
             serving with ``decode_fused=True``: the megakernel must launch
             24 times per decode step and the fused adapter 24 times per
             prefill batch; the same comparisons with its kernel_impl="ref"
             run, and the same profile of a decode step.
5. serve from a quantized bank — the same workload with bank_quant int8
             and int4, each on the composed path and with decode_fused=True,
             on the first QUANT_LAYERS (6) of the 24 layers (for the
             call's time): the engine quantizes the bank and drops
             it from its params; profiles 0 and 1 carry quantized
             aggregated store records, so the first wave admits through
             quant_mixed. The quantized aggregation launches twice per
             aggregating wave, the dequantizing adapter 6 times per decode
             step and prefill batch (composed) or per prefill batch
             (fused), the megakernel's int8/int4 route 6 times per decode
             step (fused); the bf16
             kernels not at all. Each path is held to its kernel_impl="ref"
             run as above (a reading over the adapters'-share bound is
             reported, see the tolerances), and a decode step of each is
             profiled.
6. serve from a heterogeneous bank — kernel checks first: the IA3
             scaling (#7) bitwise against its plain version at B=4, d=1024
             (T=1 and T=16 on a layer slice of the [B, 24, d] slot buffer,
             a shared s, fp32 x, mixed dtypes, s = 0 giving x bitwise),
             timed; the hetero-adapter launch (bottleneck -> LoRA -> IA3
             in one kernel, #7's redesign) bitwise equal to the CUDA
             sequence #2 -> #2 (LoRA) -> #7 for every subset of stages at
             T=1, 16 and 128 (and 17), bf16 and fp32, layer slices and
             shared operands, each stage of that sequence within the fused
             adapter's bounds of its plain version, zero B_hats with s = 0
             giving x bitwise, timed beside that sequence; at the widths
             no cluster of the launch fits with a bottleneck and a LoRA
             stage (d=6144 at T=16, dbrx-132b's; d=7168 at T=1 and 16,
             llava-next-34b's) ``ops.hetero_adapter``'s separate route,
             #2 twice and #7 once, bitwise the CUDA sequence and each
             stage within the fused adapter's bounds; the fused
             adapter's LoRA route (no LN, identity) on layer slices at T=1
             and T=16; the aggregation at the typed
             leaves' shapes (IA3 rows [624, 1024, 1], prefix rows
             [624, 8, 1024]), bitwise and timed, and bitwise again with
             -0.0 weights, two terms that cancel exactly and a padded row
             (the kernel drops zero-weight terms). Then qwen1.5-0.5b with the
             typed bank bottleneck 102 / LoRA 102 / IA3 26 / prefix 26 and
             P = 8 prefix rows, composed: the aggregation launches 10 times
             per aggregating wave, the hetero-adapter launch 24 times per
             decode step and prefill batch, #2, #7, #5, #6 and #8 not at
             all; one prefill batch holds prefix-on (cache_pos 8) and
             prefix-off (0) requests; held to its kernel_impl="ref" run and
             profiled as the other paths. With decode_fused=True the
             megakernel must not launch (hetero entries stay composed), the
             hetero-adapter launch runs as composed and the tokens equal
             the composed run's. Then #7 on the entries it keeps (IA3
             alone) through the model's forward: 24 launches, bitwise the
             kernel_impl="ref" forward.
7. train   — the paper's loop on qwen1.5-0.5b at full width. One xpeft
             train step on the card against the same step on the CPU (2
             layers, float32, TF32 off, the same weights, batch and Gumbel
             draws): the k-hot selection bitwise, the loss and every
             trainable gradient leaf within the stated tolerances. Ten
             steps at full depth in bf16 through ``launch/train.py``'s
             loop (8 profiles, B=8, T=64): every loss and grad norm
             finite, the mask logits moved; ms per step (CUDA events),
             tokens/s, peak memory, then device time and kernels per step
             under the profiler. The trained table packed into a hard
             (k=50) and a soft store, each saved, loaded back and held
             byte for byte. The hard store served per step
             (``precompute=False``): the aggregation, the fused adapter
             and, with ``decode_fused=True``, the megakernel must not
             launch; held to the same store's precompute=True
             kernel_impl="ref" run. The soft store served precomputed
             (dense admission, the fused adapter 24 times per decode step
             and prefill batch, the aggregation never), held to its ref
             run. A ``{"train": ...}`` JSON line carries the training
             numbers.
8. encoder — the paper's own model, bert-base-xpeft, at full width (12
             layers, d=768, vocab 30522, learned positions, bidirectional
             attention, N=100, b=48, k=50, 15 labels) on 8 profiles of
             ProfileClassification at the paper's shape (B=64, T=128),
             bf16, lr 3e-2: (a) one step of xpeft (hard masks, the same
             Gumbel draws), adapter and head_only on the card against the
             CPU (2 layers, float32, TF32 off) within phase 7's bounds,
             accuracy equal; (b) ten full-depth xpeft steps through
             ``make_train_step`` (timed and profiled as phase 7's), three
             each of xpeft soft, adapter and head_only, with no hand-
             written kernel launched; (c) held-out accuracy (reported);
             (d) the trained profiles and heads packed into a hard store,
             saved, loaded back byte-equal, and scored from it through
             the dense mask weights; (e) the same store admitted through
             the kernels: #1 twice (P=96, k=50), #2 once per layer (B=64,
             T=128, b=48), the logits held to the same route's
             kernel_impl="ref" run. An ``{"encoder": ...}`` JSON line
             carries its numbers. Phase 3 also checks and times #1 at
             the encoder's bank [1200, 768, 48] (both sides) and #2 at its
             B=64, T=128 shape and at b=48, bf16 T=1 and fp32 T=16.

9. continuous — qwen1.5-0.5b at full width and 12 of its 24 layers
             (CUT_LAYERS; bf16, random weights from seed 0) on
             ``benchmarks/cb_smoke.py``'s skewed workload (12 requests,
             prompts of 3-12 tokens, 3 profiles, 1 in 3 long
             with 40 new tokens, the rest 2), 4 slots, max_seq 128,
             page_size 16, sync_every 8: (a) bf16 composed, continuous
             against windowed; (b) continuous with long_new 100 on 10
             pages (two long requests need 14: preemptions and resumes
             must be > 0) against the unstarved pool; (c) decode_fused,
             (d) int8 and (e) phase 6's hetero bank, each continuous
             against windowed; (f) self-speculation (gamma 3) against
             (a)'s continuous run, and on (b)'s starved pool against (b);
             (g) (a)'s continuous engine with 2 mask entries for its 4
             slots (``mask_pages=2``) and ``max_wait_waves=2`` against
             (a)'s continuous run: at most 2 entries in use, requests
             refused an entry (OOM events and requeues > 0), as many
             device steps as (a) or more, both allocators' audits.
             Each drain runs with every counter at 0 just before it and
             must launch what its path launches per decode step (a
             speculation round: gamma drafts and the verify, #2 in every
             layer of each), prefill batch and aggregating wave; the
             continuous runs must strand fewer slot steps in fewer device
             steps than windowed, the spec runs commit more than one
             token per step in fewer steps. Every request's tokens are
             held to the reference run's: where they part, the first
             recorded logits where the runs differ (the prefill, with
             both batch shapes, or a decode step) are named and the
             first flip must lie on a reference top-2 gap of at most
             twice that step's max |d logit|. One step of (a) and
             (c)-(f) is timed and profiled, with the paged gather and
             writeback on its pool as CUDA-graph replays ((b)'s and
             (g)'s steps have (a)'s shapes, the starved spec run's
             (f)'s; (g) shares (a)'s warm-up). Phase 3b checks and times
             #2 at the verify's shape (B=4, T=4, layer slices).
10. resilience — ``tools/resilience_phase.py``, at phase 9's depth (12
             layers, full width): (a) training over the typed
             bank bottleneck 102 / LoRA 102 / IA3 26 / prefix 26, P=8: one
             step on the card against the CPU (2 layers, float32, one
             example's masks selecting no prefix slot) under phase 7's
             bounds, ten full-depth bf16 steps timed and profiled, the
             trained profiles packed, reloaded byte-equal and served
             precomputed (#1 10 times per aggregating wave, the hetero-
             adapter launch 24 times per step and prefill batch), held to
             their kernel_impl="ref" run; (b) per-step serving over the
             prefix-free spec 115 / 115 / 26, hard and soft profiles,
             windowed and continuous at one admission wave: tokens equal,
             no hand-written kernel launched, a step profiled; (c) and
             (d) on the first 6 layers (``OPS_LAYERS``): (c) a fault
             plan (a persistent, a transient and a corrupt profile of 6)
             on bf16 composed, decode_fused, int8 composed, hetero
             composed and continuous composed on 10 pages: the degraded
             set the plan's, retries, one quarantined profile, the peers
             bitwise the no-fault run, the degraded requests bitwise the
             X-PEFT-disabled engine, a degraded request preempted and
             resumed; (d) obs on against off on composed continuous and
             decode_fused (tokens bitwise, host syncs equal), the metrics
             JSON and Chrome trace exported and validated, TTFT p50/p95,
             kernels and device ms per step with the slot accumulator
             taken out, obs off and obs on. Its numbers are the kernels
             line's ``resilience`` key.
11. lifecycle — ``tools/lifecycle_phase.py``: the profile lifecycle on
             qwen1.5-0.5b at full width and CUT_LAYERS layers (phase 4's
             weights cut to them), bf16, MarkovLM over 8
             profiles: (a) onboarding through 4 roster slots (4 examples
             per slot, T=32, lr 1e-3, graduation at 10-20 steps, a fault
             plan poisoning slot 3): the graduated, quarantined and
             evicted sets those of the same run on the CPU at 2 layers,
             no roster tensor reallocated across waves, host syncs per
             step < 1, no scatter-add kernel in the gang step; ms per gang
             step, device ms and kernels per step, peak memory, graduation
             ms; (b) the run checkpointed every 10 steps, preempted at 15,
             resumed, then resumed again past a truncated checkpoint: both
             stores byte-equal to (a)'s, the rosters bitwise; save,
             restore and bytes; (c) one gang step on the card against the
             CPU (2 layers, float32) under phase 7's bounds, the parked
             and poisoned rows bitwise unchanged; (d) the graduated store,
             loaded from disk, served through #1 and #2 and held to its
             kernel_impl="ref" run. A ``{"lifecycle": ...}`` JSON line
             carries its numbers.

12. moe    — ``tools/moe_phase.py``: qwen3-moe-30b-a3b at full width and
             depth (48 layers, d=2048, 128 experts, top-8, vocab 151,936;
             bf16, random weights from seed 0, bank N=256, b=64, k=50):
             (k) #1, #2, #5 and #6 checked and timed at its shapes; (e)
             one xpeft step on the card against the CPU (2 layers, float32,
             the aux loss too) under phase 7's bounds, ten full-depth steps
             timed and profiled, the trained table packed, saved and
             reloaded byte-equal; on phase 4's workload and the first 8
             of the 48 layers (``SERVE_LAYERS``, for the call's time),
             (a) composed windowed serving (#1 twice per aggregating
             wave, #2 8 times per decode step and prefill batch) held to
             its kernel_impl="ref" run with every layer's routing recorded:
             each request's first routing flip on a reference router-
             logit gap of at most twice its max |d router logit|, and,
             teacher-forced with the ref run's routing replayed, every
             logit under phase 4's bounds; a decode step profiled, the
             expert GEMMs' share and the step's byte bound;
             (b) decode_fused=True: #8 0 launches, tokens bitwise (a)'s;
             (c) continuous against (a) by the routing rule, then spec
             gamma 3 against continuous (reported); (d) the int8 bank
             (#5, #6) held as (a); (f) the trained store served as (a). A
             ``{"moe": ...}`` JSON line carries its numbers;
             ``launches_moe`` in each kernel row.

13. forms  — ``tools/forms_phase.py``: the attention forms and #8's
             GLU-GELU and wide-row builds (bf16, random weights from seed
             0, bank N=256, b=64, k=50): (d) #8 against its plain version
             at one full-width layer of gemma-2b (4 and 8 slots),
             musicgen-medium (8), deepseek-7b (8) and llava-next-34b (4),
             S=128 and 2,048, every route, timed beside its byte bound;
             (a) gemma-2b at full width and depth: a card-vs-CPU train
             step (2 layers, float32), ten full-depth steps, then composed,
             decode_fused (#8 18 times a step), int8 and int4 serving each
             held to its kernel_impl="ref" run, continuous bitwise the
             windowed run, spec gamma 3 against continuous (these four on
             its first 9 layers, ``GEMMA_CUT``); (b)
             gemma3-27b at full width and 12 of its 62 layers, prompts of
             1,000-1,100 tokens and 16 new (``forms_phase.LONG_NEW``) at
             max_seq 2,048 (chunked prefill, decode past the 1,024
             window): composed and int8 held to their ref
             runs, continuous bitwise windowed, decode_fused launching #8 0
             times with the composed tokens; #1 and #2 at its shapes; (c)
             musicgen-medium at full width and 12 of its 48 layers
             (``forms_phase.MUSIC_LAYERS``, the call's time) through
             make_prefill_step with 64 prefix rows and make_decode_step,
             composed and decode_fused at 8 slots, each held to its ref
             run, and a card-vs-CPU train step with prefix_embeds. A
             ``{"forms": ...}`` JSON line carries its numbers;
             ``launches_forms`` in each kernel row.

14. recurrent — ``tools/recurrent_phase.py``: the recurrent block
             families on the shared chunked linear attention (bf16, random
             weights from seed 0, bank N=256, b=64, k=50): (d) #1, #2,
             #5/#6 int8 and the hetero launch at rwkv6-7b's d=4096, each
             held to its plain version and timed; (a) the chunked GLA
             against the naive fp32 recurrence at rwkv6-7b's and
             zamba2-1.2b's shapes (T=1,024, chunk 128), strong decay, the
             decode step after a chunked prefix, the refusal at T=20; (b)
             rwkv6-7b at full width: a card-vs-CPU train step (2 layers,
             float32, and its float64 twin), composed on 8 of its 32
             layers held to its ref run, a
             decode step split by op class, four 1,024-token prompts in one
             exact-length prefill batch, then on its first 8 layers int8
             and a heterogeneous bank held to their ref runs, continuous
             (no page pool) and decode_fused (#8 0 times) bitwise the
             windowed run; (c) zamba2-1.2b at full width: a card-vs-CPU
             step (6 layers), on 14 of its 38 layers composed held to its
             ref run,
             continuous with preemptions and decode_fused bitwise
             windowed. A ``{"recurrent": ...}`` JSON line carries its
             numbers; ``launches_recurrent`` in each kernel row.

15. mesh   — ``tools/mesh_phase.py``: multi-device serving of
             qwen1.5-0.5b at full width and CUT_LAYERS layers: (a) a
             world-1 NCCL mesh 1x1:data,model in this process, composed,
             decode_fused, continuous and int8 bitwise their mesh=None
             runs, #1, #2, #5, #6 and #8 launched on the mesh runs; (b)
             two processes on the one card over gloo (its collectives
             checked on CUDA tensors first), the mesh 2x1, the
             composed tokens bitwise (a)'s mesh=None run, #1 and #2
             launched on each rank, resident bytes per device against
             one device, a decode step's host ms, device ms and bytes
             gathered. A ``{"mesh": ...}`` JSON line carries its numbers;
             ``launches_mesh`` (the (a) runs) and ``launches_mesh_b``
             (rank 0 of each (b) mesh) in each kernel row.

16. mesh train — ``tools/mesh_train_phase.py``: multi-device training.
             (a) a world-1 NCCL mesh 1x1:data,model, qwen1.5-0.5b at full
             width and MESH_TRAIN_LAYERS layers: a gang step and a plain xpeft
             step bitwise their mesh=None steps; then two processes on
             the one card over gloo: (b) JAX's elastic drill at 2x1 (an
             unfailed run, a run checkpointed at 4 and stopped at 6, one
             2x1 gang step against one device), resumed in a new world of
             one process on the surviving 1x1 mesh, its store against
             the unfailed run's and served on the 1x1 mesh (#1 and #2
             counted, tokens bitwise mesh=None); (c) 1x2: the plain step
             with the frozen tree as "model" blocks in phase 7's bounds,
             resident and peak bytes, bytes gathered, host and device ms
             a step; (d) qwen3-moe-30b-a3b at full width, expert
             parallel at 1x2: a forward of 8 layers under phase 12's
             routing rule, a float32 train step at 2 layers in phase 7's
             bounds, each rank's expert bytes half of one device's. A
             ``{"mesh_train": ...}`` JSON line carries its numbers;
             ``launches_mesh_train`` in each kernel row.

17. dry run — ``tools/dryrun_phase.py``: the dry run's resident bytes
             against the allocator, its decode step's peak beside the
             card's, ``cfg.remat`` none / full / dots bitwise.

18. float8 cache — ``tools/kv_f8_phase.py``, run right after phase 9 on
             phase 4's weights: (a) #8 on float8_e4m3fn caches against
             its plain version (routes none, bf16, int8, int4 at S=128;
             bf16 at S=2048; S=256's one split), its new K/V rows
             byte-equal to the cast of its bf16-cache rows (also past
             448: NaN bytes), timed beside the bf16 cache in turns; (b)
             composed and decode_fused drains on a float8 cache at
             CUT_LAYERS held to their ref runs, #8 L x decode steps, K/V
             bytes half the bf16 engine's; (c) continuous on a pool that
             preempts, bitwise windowed, and spec under the flip rule. A
             ``{"kv_f8": ...}`` JSON line carries its numbers;
             ``launches_kv_f8`` in each kernel row, and a kernel row of
             its own for #8's float8 build.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit; before that one JSON line of kernel numbers.
"""
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, stated before any run:
# - mask aggregation: the kernel and its plain version do the same rounded
#   multiply then rounded add per term, in the same order -> atol 1e-6
#   (bitwise agreement expected; the error is printed).
# - fused adapter, bf16: both sum in fp32 (in other orders) and round once
#   to bf16, so an element may differ by one bf16 rounding step:
#   |kernel - plain| <= 2^-7 * |plain| + 1e-5. fp32 inputs: rtol 1e-4,
#   atol 1e-5.
# - end to end, kernel run vs ref run, the prefill logits and the decode-
#   step logits under teacher forcing: max |d logit| <= E2E_STEPS bf16
#   steps at the largest logit (the logits are bf16 products, and adapter
#   outputs one bf16 step apart propagate through 24 bf16 layers), and
#   <= E2E_SHARE_REL of the adapters' share of the logits (max |ref run -
#   the same run with the adapter left out|), so an adapter that comes
#   out wrong by half of itself or more (a wrong layer or slot row, a
#   dropped term) fails even where that share is smaller than the bf16
#   bound. Both set from the readings on an H100 (PERF.md): decode logits
#   2 bf16 steps apart, 0.31 of a 0.199 share; prefill logits equal.
#   Finer faults (a wrong activation form moves h by ~1e-3) are the
#   kernel phases' to catch. On the quantized-bank paths (phase 5) both
#   bounds are computed the same way; the E2E_STEPS bound and the flip
#   explanations are asserted, and a reading over E2E_SHARE_REL is
#   reported (printed as EXCEEDS and carried in the JSON line as
#   share_bound_met: false) rather than ending the run: the first chip
#   runs read 0.505 on int4 with decode_fused (PERF.md, ROADMAP queue 3),
#   with the logits 3.1 bf16 steps apart, as on the bf16 route. Beside it
#   the same teacher-forced decode steps run with the adapter left out in
#   both runs (prefill keeps it): the part of the difference the decode
#   steps' adapter does not make. The heterogeneous-bank path (phase 6)
#   asserts both bounds as the bf16 paths do; its "adapter left out" run
#   drops all four families, the prefix rows included, so the share also
#   holds the shift of every prefix-on prompt's positions by P.
# - a greedy token may differ between the two runs only where the ref
#   run's top-2 gap at that step is <= 2 * that step's max |d logit|.
# - decode megakernel vs its plain version (same rounding points, fp32
#   sums in other orders, cosf/expf/rsqrtf against PyTorch's): y and the
#   K/V rows within DEC_STEPS bf16 steps at each output's largest |value|
#   (an element rounded one step apart upstream moves what follows by
#   about one step). Routes int8/int4 are held to the same DEC_STEPS
#   bound: they round at fewer points than route bf16 (none inside the
#   adapter), and their dequantized values are exact.
# - quantized aggregation (#5): each dequantized term is exact and the
#   kernel repeats the plain version's rounded multiply then rounded add
#   in k order -> AGG_ATOL (bitwise expected); with one-hot weights each
#   term alone must be bitwise equal.
# - dequantizing fused adapter (#6): as the bf16 fused adapter (#2): fp32
#   inside, one rounding to x's dtype -> FA_BF16 (bf16 x) / FA_F32 (fp32 x).
AGG_ATOL = 1e-6
DEC_STEPS = 4
DEC_POS = [3, 0, 77, 130, 127, 1, 50, 128]  # per slot; S = 128
# 16 slots (two launches of the 8-slot instantiation): DEC_POS, then eight
# more with one past the cache's end
DEC_POS16 = DEC_POS + [64, 100, 2, 126, 129, 31, 90, 15]
DEC_LONG_S, DEC_LONG_POS = 2048, [2047, 0, 1000, 1500]  # the long cache
FA_BF16_RTOL, FA_BF16_ATOL = 2.0 ** -7, 1e-5
FA_F32_RTOL, FA_F32_ATOL = 1e-4, 1e-5
E2E_STEPS = 4
E2E_SHARE_REL = 0.5
# - training (phase 7), one step on the card against the same step on the
#   CPU, both float32 with TF32 off: the k-hot selection bitwise; the loss
#   within TRAIN_LOSS_RTOL of the CPU's (fp32 sums over 151936 logits and
#   512 tokens in other orders); each trainable gradient leaf within
#   TRAIN_GRAD_REL_L2 relative L2 error (gradients pass back through the
#   LM head, 2 layers and the straight-through softmax).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL_L2 = 1e-3
# - a step whose float32 gradients are too ill-conditioned for that bound
#   (rwkv6-7b at random init: ``tools/grad_floor.py``) also runs in float64
#   on both devices (``float64_everywhere``), where the card must give the
#   CPU's loss and gradients within TRAIN_F64_REL: float64 rounding (1.1e-16)
#   times the amplification its float32 gradients show (their distance
#   from float64 over float32's 6e-8, up to 7e4) is ~1e-11 (rwkv6-7b read
#   1.7e-11 to 2.5e-11 on an H100)
TRAIN_F64_REL = 1e-9
# phases 9, 10 and 11 drive their paths at this depth of qwen1.5-0.5b (24
# layers) and full width, so that the whole script, phase 12's 48-layer
# model included, stays well inside its time limit: their serving and
# training steps are host-bound, so their time follows the layer count
CUT_LAYERS = 12
# phase 16 (mesh training) runs qwen1.5-0.5b at full width on this depth:
# its checks are bitwise on one-process meshes or in phase 7's relative
# bounds, and its gloo gathers pass through the host, so its time follows
# the layer count (84.4 s at CUT_LAYERS in a whole run of 1,145.0 s on an
# H100 host with slow CPUs)
MESH_TRAIN_LAYERS = 6
# phase 5 serves its four quantized paths on the first QUANT_LAYERS of
# qwen1.5-0.5b's 24 layers (full width), for the whole call's time (its
# adapters'-share readings are reported, not asserted)
QUANT_LAYERS = 6
# - the encoder (phase 8): its card-vs-CPU step under phase 7's two bounds
#   for every mode, with the accuracy equal (fp32 logits of 15 classes);
#   its kernel route against the same route's kernel_impl="ref" run under
#   E2E_STEPS bf16 steps at the largest |logit|, each predicted-label flip
#   on a ref top-2 gap of at most twice the max |d logit|.

# #1-#4, #6 and #8 as this script timed them before their redesign for
# Hopper (one block row per output row; one block per batch row and
# 16-token tile; #8 one (slot, head) per block over all S rows, GEMV
# tasks of 16 columns), in ms on an NVIDIA H100 80GB HBM3 at 700 W: #1
# eager calls, the rest cold CUDA-graph replays (#8 at S=2048 timed the
# same way by tools/decode_phases.py on the tree before the redesign).
# The hetero sequence (#2, #2's LoRA route, #7, before the hetero-adapter
# launch) is the sum of those kernels' rows at B=4, d=1024, bf16; #5's
# replay times are tools/agg_quant_probe.py's on the tree before its
# redesign, with this script's inputs.
# Printed in the log beside this run's times; never asserted and never in
# the JSON lines.
BEFORE_MS = {"A_hat": 0.1894, "B_hat": 0.1860, "ia3 rows": 0.0553,
             "prefix rows": 0.0488, "T=1": 0.04071, "T=16": 0.23646,
             "unbatched T=256": 0.21530, "one profile": 0.02405,
             "int8 T=1": 0.06911, "int8 T=16": 0.26329,
             "int4 T=1": 0.05330, "int4 T=16": 0.22209,
             "KV=16 route=bf16": 0.08387, "KV=16 route=none": 0.07247,
             "KV=4 route=bf16": 0.08207, "KV=16 route=int8": 0.08688,
             "KV=16 route=int4": 0.08698,
             "KV=16 route=bf16 S=2048": 0.52184,
             "hetero sequence T=1": 0.01666, "hetero sequence T=16": 0.02765,
             "int8 g32 A_hat replay": 0.20217,
             "int8 g32 B_hat replay": 0.19858,
             "int4 g32 A_hat replay": 0.22778,
             "int4 g32 B_hat replay": 0.22811}


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def device_ms(torch, fn, calls, reps=7):
    """Median device time of one ``fn()`` call: ``calls`` calls captured in
    a CUDA graph, replayed ``reps`` times between CUDA events (no host
    launch cost inside the timed span)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def eager_ms(torch, fn, calls, reps=5):
    """Median time of one call issued from Python, host cost included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def rotating(fn, arg_sets):
    """A no-argument call that applies ``fn`` to the next argument set."""
    i = [0]

    def call():
        args = arg_sets[i[0] % len(arg_sets)]
        i[0] += 1
        return fn(*args)
    return call


def bound(nbytes, flops, dtype):
    """(ms, what binds) of the least time the card could take for a call
    that moves ``nbytes`` and does ``flops`` of ``dtype``, on the H100's
    constants in ``repro_torch.analysis.roofline``."""
    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ----------------------------------------------------------------------------
# phase 3a: mask aggregation
# ----------------------------------------------------------------------------

def agg_inputs(torch, gen, d, b, L=24, N=256, P=96, k=50):
    """A bank [L*N, d, b] bf16 and P index rows (P / L profiles x L
    layers, layer-folded) of k sorted distinct adapters each, as admission
    builds them."""
    dev = "cuda"
    bank = (torch.randn((L * N, d, b), generator=gen, device=dev)
            * 0.05).to(torch.bfloat16)
    sel = torch.rand((P, N), generator=gen, device=dev).argsort(-1)[:, :k]
    layer = torch.arange(P, device=dev) % L
    idx = (sel.sort(-1).values + (layer * N)[:, None]).to(torch.int32)
    w = torch.full((P, k), 1.0 / k, dtype=torch.float32, device=dev)
    return bank, idx.contiguous(), w


def agg_row(torch, KA, ref, F, label, sets, before=None):
    """One timed row of #1: the first (bank, idx, w) set bitwise against
    the plain version, padded rows exact zeros, two calls bitwise equal;
    then cold CUDA-graph replays rotating over ``sets`` (one set where its
    bank alone is far past the 50 MB L2), eager calls, the plain version
    and embedding_bag, beside the bound of the first set's bytes."""
    bank, idx, w = sets[0]
    P, k = idx.shape
    d, b = bank.shape[1:]
    got = KA.mask_aggregate_batched(bank, idx, w)
    want = ref.mask_aggregate_batched_ref(bank, idx, w)
    again = KA.mask_aggregate_batched(bank, idx, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (P, d, b)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = (got - want).abs().max().item()
    log(f"mask_aggregate_batched[{label}] P={P} k={k} bank "
        f"{tuple(bank.shape)} bf16: max_abs_err {err:.3e} "
        f"(bitwise {torch.equal(got, want)}; atol {AGG_ATOL})")
    assert err <= AGG_ATOL, err
    # padded profile-rows (idx 0, w 0) come out as exact zeros
    pad = KA.mask_aggregate_batched(bank, torch.zeros_like(idx[:2]),
                                    torch.zeros_like(w[:2]))
    assert not pad.abs().max().item()

    ms = device_ms(torch, rotating(KA.mask_aggregate_batched, sets),
                   calls=8 * len(sets))
    host_ms = eager_ms(torch, rotating(KA.mask_aggregate_batched, sets),
                       calls=3 * len(sets))
    plain_ms = eager_ms(torch, lambda: ref.mask_aggregate_batched_ref(
        bank, idx, w), calls=1)
    row_bytes = d * b * bank.element_size()
    uniq = int(torch.unique(idx).numel())
    nbytes = uniq * row_bytes + idx.numel() * 4 + w.numel() * 4 \
        + P * d * b * 4
    flops = 2 * P * k * d * b
    bound_ms, bound_by = bound(nbytes, flops, "float32")
    # yardstick only, never called by the port: embedding_bag with
    # per-sample weights computes the same weighted sum of rows
    bags = [(i, t.view(t.shape[0], -1), v.to(t.dtype)) for t, i, v in sets]

    def bag(i, flat, w16):
        return F.embedding_bag(i, flat, per_sample_weights=w16, mode="sum")
    lib_ms = device_ms(torch, rotating(bag, bags), calls=8 * len(sets))
    lib_eager = eager_ms(torch, rotating(bag, bags), calls=3 * len(sets))
    log(f"  ms {ms:.4f} (cold graph replay) | eager {host_ms:.4f}"
        + (f" (before: eager {before})" if before else "")
        + f" | plain {plain_ms:.4f} | embedding_bag {lib_ms:.4f} (eager "
        f"{lib_eager:.4f}) | bound {bound_ms:.4f} ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {uniq} distinct rows) | "
        f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                eager_ms=host_ms, library_eager_ms=lib_eager)


def phase_mask_aggregate(torch, KA, ref, F):
    """#1 at admission's A_hat / B_hat shapes (P=96, k=50): bitwise, padded
    rows exact zeros, two calls bitwise equal; timed as cold CUDA-graph
    replays (the 805 MB bank holds every call's ~525 MB of selected rows
    far past the 50 MB L2, so no rotation is needed) and as eager calls
    (the reading before the redesign), beside embedding_bag and the plain
    version. Then the same at the encoder's shapes (bert-base-xpeft's
    bank [12 x 100, 768, 48] and its B side, P = 8 profiles x 12 layers,
    k=50), rotating over three banks (88 MB each) to stay cold."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = []
    for label, (d, b) in (("A_hat", (1024, 64)), ("B_hat", (64, 1024))):
        sets = [agg_inputs(torch, gen, d, b)]
        results.append(agg_row(torch, KA, ref, F, label, sets,
                               BEFORE_MS[label]))
        del sets
        torch.cuda.empty_cache()
    for label, (d, b) in (("encoder A_hat", (768, 48)),
                          ("encoder B_hat", (48, 768))):
        sets = [agg_inputs(torch, gen, d, b, L=12, N=100)
                for _ in range(3)]
        results.append(agg_row(torch, KA, ref, F, label, sets))
        del sets
        torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------------
# phase 3b: fused adapter
# ----------------------------------------------------------------------------

def fa_inputs(torch, gen, B, T, d, b, dtype, shared=False):
    dev = "cuda"
    lead = () if shared else (B,)

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = rnd((B, T, d), 1.0).to(dtype)
    a = rnd(lead + (d, b), d ** -0.5).to(dtype)
    bb = rnd(lead + (b, d), 0.05).to(dtype)
    ls = 1.0 + rnd(lead + (b,), 0.1)
    lb = rnd(lead + (b,), 0.1)
    return x, a, bb, ls, lb


def check_fa(torch, KF, ref, args, kw, rtol, atol, label):
    got = KF.fused_adapter_batched(*args, **kw)
    want = ref.fused_adapter_batched_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= rtol * want.float().abs() + atol).all())
    log(f"  check {label}: max_abs_err {err:.3e} ok={ok}")
    assert ok, label
    return err


def phase_fused_adapter(torch, KF, ref):
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, d, b = 4, 1024, 64
    bf16, f32 = torch.bfloat16, torch.float32
    # coverage first: fp32, shared A/B, the LoRA route, strided layer rows
    for T in (1, 16):
        args = fa_inputs(torch, gen, B, T, d, b, f32)
        check_fa(torch, KF, ref, args, {}, FA_F32_RTOL, FA_F32_ATOL,
                 f"fp32 T={T}")
        args = fa_inputs(torch, gen, B, T, d, b, bf16, shared=True)
        check_fa(torch, KF, ref, args, {}, FA_BF16_RTOL, FA_BF16_ATOL,
                 f"bf16 shared T={T}")
        check_fa(torch, KF, ref, args,
                 dict(activation="identity", use_ln=False), FA_BF16_RTOL,
                 FA_BF16_ATOL, f"bf16 shared no-LN identity T={T}")
    # T that is not a whole 16-token tile, in both dtypes
    for T in (5, 17):
        check_fa(torch, KF, ref, fa_inputs(torch, gen, B, T, d, b, bf16),
                 {}, FA_BF16_RTOL, FA_BF16_ATOL, f"bf16 T={T}")
        check_fa(torch, KF, ref, fa_inputs(torch, gen, B, T, d, b, f32),
                 {}, FA_F32_RTOL, FA_F32_ATOL, f"fp32 T={T}")
    # other bottleneck widths
    for nb in (32, 128):
        for T in (1, 16):
            check_fa(torch, KF, ref,
                     fa_inputs(torch, gen, B, T, d, nb, bf16), {},
                     FA_BF16_RTOL, FA_BF16_ATOL, f"bf16 b={nb} T={T}")
    # the cluster's partials are summed in rank order: two calls on the
    # same inputs agree bit for bit
    for T in (1, 16):
        args = fa_inputs(torch, gen, B, T, d, b, bf16)
        first = KF.fused_adapter_batched(*args)
        second = KF.fused_adapter_batched(*args)
        torch.cuda.synchronize()
        log(f"  check two calls bf16 T={T}: bitwise "
            f"{torch.equal(first, second)}")
        assert torch.equal(first, second), T
    # clusters of 16 blocks, where the planner takes them: decode of a
    # 7168-wide model (llava-next-34b) and prefill of a 6144-wide one
    # (dbrx-132b), whose slices overflow a block's shared memory at 8
    for dw, T in ((7168, 1), (6144, 16)):
        cs = KF.plan(dw, b, T, 2)
        assert cs == 16, (dw, T, cs)
        check_fa(torch, KF, ref, fa_inputs(torch, gen, B, T, dw, b, bf16),
                 {}, FA_BF16_RTOL, FA_BF16_ATOL,
                 f"bf16 d={dw} T={T}, clusters of {cs}")
    # one layer of the engine's [B, L, d, b] slot buffers, at the decode
    # (T=1) and a prefill (T=16) shape
    stack = [fa_inputs(torch, gen, B, 1, d, b, bf16)[1:] for _ in range(3)]
    a3, b3, ls3, lb3 = (torch.stack(t, 1) for t in zip(*stack))
    for T in (1, 16):
        x = fa_inputs(torch, gen, B, T, d, b, bf16)[0]
        check_fa(torch, KF, ref,
                 (x, a3[:, 1], b3[:, 1], ls3[:, 1], lb3[:, 1]), {},
                 FA_BF16_RTOL, FA_BF16_ATOL,
                 f"bf16 layer slice of [B,L,d,b] T={T}")

    results = []
    for T in (1, 16, 128):
        # the decode path finds each layer's A_hat/B_hat cold (24 layers of
        # adapters and all the weights stream between two uses), so the
        # timed calls rotate over input sets that together exceed the
        # 50 MB L2
        sets = [fa_inputs(torch, gen, B, T, d, b, bf16) for _ in range(64)]
        err = check_fa(torch, KF, ref, sets[0], {}, FA_BF16_RTOL,
                       FA_BF16_ATOL, f"bf16 per-row T={T}")
        ms = device_ms(torch, rotating(KF.fused_adapter_batched, sets),
                       calls=len(sets))
        plain_ms = device_ms(torch, rotating(ref.fused_adapter_batched_ref,
                                             sets), calls=len(sets))
        warm_ms = device_ms(torch, lambda: KF.fused_adapter_batched(
            *sets[0]), calls=64)
        host_ms = eager_ms(torch, rotating(KF.fused_adapter_batched, sets),
                           calls=len(sets))
        nbytes = sum(t.numel() * t.element_size() for t in sets[0]) \
            + sets[0][0].numel() * 2
        flops = 4 * B * T * d * b
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        before = BEFORE_MS.get(f"T={T}", "not timed")
        log(f"fused_adapter_batched B={B} T={T} d={d} b={b} bf16: ms "
            f"{ms:.5f} (cold; before {before}) | warm {warm_ms:.5f} | plain "
            f"{plain_ms:.5f} (cold) | eager call (host included) "
            f"{host_ms:.5f} | bound {bound_ms:.5f} ({bound_by}: "
            f"{nbytes / 1e6:.3f} MB)")
        results.append(dict(shape=f"T={T}", max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            warm_ms=warm_ms, eager_ms=host_ms))
        del sets
    return results + fa_slice_rows(
        torch, KF, ref, gen, "verify", 1024, 64, 24,
        ((4, CB_GAMMA + 1, torch.bfloat16),)) + fa_encoder_rows(
            torch, KF, ref, gen)


def fa_encoder_rows(torch, KF, ref, gen):
    """#2 at the encoder's shapes (bert-base-xpeft: d=768, b=48), on layer
    slices of [B, 12, ...] Â/B̂/LN buffers as the encoder's admitted entry
    hands them to each layer: B=64, T=128 bf16 (the path's own shape; two
    calls bitwise equal), then B=4 at bf16 T=1 and fp32 T=16, where the
    CUDA-core path splits each column over 256 // 48 = 5 sub-slices and
    the LN loop runs over 48 columns."""
    return fa_slice_rows(torch, KF, ref, gen, "encoder", 768, 48, 12,
                         ((64, 128, torch.bfloat16), (4, 1, torch.bfloat16),
                          (4, 16, torch.float32)))


def fa_slice_rows(torch, KF, ref, gen, name, d, nb, L, shapes):
    """#2 on layer slices of [B, L, ...] Â/B̂/LN buffers, as an admitted
    entry hands them to each layer, at each (B, T, dtype) of ``shapes``:
    checked within #2's bounds, two calls bitwise equal, and timed as cold
    CUDA-graph replays rotating over the L layers' slices and four x,
    beside the plain version and the bound of one call's bytes. Phase 9's
    verify (B=4, T=gamma+1, qwen's d=1024, b=64) and the encoder's
    shapes."""
    rows = []
    for B, T, dtype in shapes:
        bf16 = dtype == torch.bfloat16
        rtol, atol = (FA_BF16_RTOL, FA_BF16_ATOL) if bf16 else \
            (FA_F32_RTOL, FA_F32_ATOL)
        layers = [fa_inputs(torch, gen, B, T, d, nb, dtype)
                  for _ in range(L)]
        xs = [t[0] for t in layers[:4]]
        a3, b3, ls3, lb3 = (torch.stack(t, 1)
                            for t in zip(*(t[1:] for t in layers)))
        del layers
        sets = [(xs[l % 4], a3[:, l], b3[:, l], ls3[:, l], lb3[:, l])
                for l in range(L)]
        label = f"{name} B={B} T={T} d={d} b={nb} " \
            f"{'bf16' if bf16 else 'fp32'}"
        err = check_fa(torch, KF, ref, sets[1], {}, rtol, atol, label)
        first = KF.fused_adapter_batched(*sets[1])
        second = KF.fused_adapter_batched(*sets[1])
        torch.cuda.synchronize()
        log(f"  check two calls {label}: bitwise "
            f"{torch.equal(first, second)}")
        assert torch.equal(first, second), label
        ms = device_ms(torch, rotating(KF.fused_adapter_batched, sets),
                       calls=len(sets))
        plain_ms = device_ms(torch, rotating(ref.fused_adapter_batched_ref,
                                             sets), calls=len(sets))
        x = sets[0][0]
        nbytes = sum(t.numel() * t.element_size() for t in sets[0]) \
            + x.numel() * x.element_size()
        flops = 4 * B * T * d * nb
        bound_ms, bound_by = bound(nbytes, flops,
                                   "bfloat16" if bf16 else "float32")
        log(f"fused_adapter_batched {label}: ms {ms:.5f} (cold) | plain "
            f"{plain_ms:.5f} (cold) | bound {bound_ms:.5f} ({bound_by}: "
            f"{nbytes / 1e6:.3f} MB)")
        rows.append(dict(shape=label, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))
        del sets, xs, a3, b3, ls3, lb3, first, second
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------------
# phase 3c: the decode megakernel
# ----------------------------------------------------------------------------

def dec_layers(torch, gen, d, H, KV, hd, ff, L):
    """L layers of decoder weights at init_lm's scales, with the QKV
    biases and the norm scales (zero at init) drawn at random, so the bias
    add and the (1 + scale) factor are exercised."""
    def w(shape, fan_in):
        return (torch.randn(shape, generator=gen, device="cuda")
                / math.sqrt(fan_in)).to(torch.bfloat16)

    def f(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return [{"n1": {"scale": f((d,), 0.1)}, "n2": {"scale": f((d,), 0.1)},
             "attn": {"wq": w((d, H, hd), d), "wk": w((d, KV, hd), d),
                      "wv": w((d, KV, hd), d), "wo": w((H, hd, d), H * hd),
                      "bq": f((H, hd), 0.1), "bk": f((KV, hd), 0.1),
                      "bv": f((KV, hd), 0.1)},
             "mlp": {"wg": w((d, ff), d), "wu": w((d, ff), d),
                     "wd": w((ff, d), ff)}} for _ in range(L)]


def dec_inputs(torch, gen, cfg, KV, L=24, B=4, S=128, quant=None,
               pos=None):
    """Decode-step inputs at qwen1.5-0.5b's widths: x [B,1,d], pos (default
    the first B of DEC_POS: 130 and 128 >= S, the drop case), and per layer its
    weights, its [B,S,KV,hd] cache slice and one layer of the engine's
    [B,L,d,b] adapter buffers (strided rows); with ``quant`` = (QS,
    scheme, group), the buffers' quantized records in place of Â/B̂."""
    d, H, hd, ff = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    nb = cfg.xpeft.bottleneck
    dev = "cuda"
    x = torch.randn((B, 1, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(DEC_POS[:B] if pos is None else pos,
                       dtype=torch.int32, device=dev)
    kc = torch.randn((L, B, S, KV, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn((L, B, S, KV, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    masks = {
        "a_hat": (torch.randn((B, L, d, nb), generator=gen, device=dev)
                  / math.sqrt(d)).to(torch.bfloat16),
        "b_hat": (torch.randn((B, L, nb, d), generator=gen, device=dev)
                  * 0.05).to(torch.bfloat16),
        "ln_scale": 1.0 + 0.1 * torch.randn((B, L, nb), generator=gen,
                                            device=dev),
        "ln_bias": 0.1 * torch.randn((B, L, nb), generator=gen, device=dev),
    }
    if quant is not None:
        QS, scheme, group = quant
        masks.update(quant_records(QS, scheme, group, masks.pop("a_hat"),
                                   masks.pop("b_hat")))
    layers = dec_layers(torch, gen, d, H, KV, hd, ff, L)
    return [(x, pos, layers[l], kc[l], vc[l],
             {k: v[:, l] for k, v in masks.items()}) for l in range(L)]


def dec_bytes(args, route):
    """Bytes one call must move: every weight, norm and bias read once,
    the K/V cache rows this data attends (rows s <= min(pos, S-1), minus
    the row the new one replaces), the route's adapter rows, x, and the
    outputs written once."""
    x, pos, block, kc, vc, masks_l = args
    B, S = kc.shape[:2]
    row = kc[0, 0].numel() * kc.element_size()
    n = sum(t.numel() * t.element_size() for sub in block.values()
            for t in sub.values())
    rows = sum(min(p + 1, S) - (p < S) for p in pos.tolist())
    n += 2 * rows * row + pos.numel() * 4
    if route != "none":
        n += sum(t[0].numel() * t.element_size() * B
                 for t in masks_l.values())
    n += 2 * x.numel() * x.element_size() + 2 * B * row
    return n


def dec_flops(args, route):
    x, pos, block, kc, vc, masks_l = args
    B, S = kc.shape[:2]
    w = sum(t.numel() for sub in block.values() for t in sub.values()
            if t.dim() > 1)
    H, hd = block["attn"]["wq"].shape[1:]
    n = 2 * B * w + sum(4 * H * hd * min(p + 1, S) for p in pos.tolist())
    if route != "none":
        n += 4 * B * masks_l["ln_scale"].shape[-1] * x.shape[-1]
    return n


def check_dec(torch, KD, ref, args, kw, label):
    """Kernel vs plain version on the card: y and the K/V rows within
    DEC_STEPS bf16 steps at each output's largest magnitude."""
    got = KD.decode_block_fused(*args, **kw)
    want = ref.decode_block_ref(*args, **kw)
    torch.cuda.synchronize()
    errs = []
    for g, w, name in zip(got, want, ("y", "k_rows", "v_rows")):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all(), (label, name)
        diff = (g.float() - w.float()).abs()
        err = diff.max().item()
        tol = DEC_STEPS * bf16_step(w.float().abs().max().item())
        log(f"  check {label} {name}: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}; {int((diff > 0).sum())} of {diff.numel()} "
            f"elements differ)")
        assert err <= tol, (label, name, err, tol)
        errs.append(err)
    return max(errs)


def phase_decode_block(torch, KD, ref, cfg, QS):
    gen = torch.Generator(device="cuda").manual_seed(3)
    kw = dict(norm=cfg.norm, qkv_bias=cfg.qkv_bias,
              use_rope=cfg.pos == "rope", theta=cfg.rope_theta,
              cap=cfg.logit_softcap, mlp_type=cfg.mlp_type, act_name=cfg.act,
              adapter_act=cfg.xpeft.adapter_activation)
    results = []
    kv = cfg.num_kv_heads
    for KV, route, S in ((kv, "none", 128), (kv, "bf16", 128),
                         (4, "bf16", 128), (kv, "int8", 128),
                         (kv, "int4", 128), (kv, "bf16", DEC_LONG_S)):
        quant = (QS, route, cfg.xpeft.quant_group) \
            if route in ("int8", "int4") else None
        long = S == DEC_LONG_S
        sets = dec_inputs(torch, gen, cfg, KV, quant=quant, S=S,
                          pos=DEC_LONG_POS if long else None)
        rkw = dict(kw, adapter=route)
        label = f"KV={KV} route={route}" + (f" S={S}" if long else "")
        err = check_dec(torch, KD, ref, sets[0], rkw, label)
        # a second layer's inputs, then the kernel's own run-to-run equality
        check_dec(torch, KD, ref, sets[7], rkw, label + " layer 7")
        again = KD.decode_block_fused(*sets[0], **rkw)
        first = KD.decode_block_fused(*sets[0], **rkw)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
        # cold: the calls rotate over the 24 layers' weights, cache slices
        # and adapter rows (~660 MB), as the decode path reads them
        ms = device_ms(torch, rotating(
            lambda *a: KD.decode_block_fused(*a, **rkw), sets),
            calls=len(sets))
        plain_ms = device_ms(torch, rotating(
            lambda *a: ref.decode_block_ref(*a, **rkw), sets),
            calls=len(sets))
        host_ms = eager_ms(torch, rotating(
            lambda *a: KD.decode_block_fused(*a, **rkw), sets),
            calls=len(sets))
        nbytes = dec_bytes(sets[0], route)
        bound_ms, bound_by = bound(nbytes, dec_flops(sets[0], route),
                                   "bfloat16")
        log(f"decode_block_fused B=4 S={S} d={cfg.d_model} H="
            f"{cfg.num_heads} KV={KV} ff={cfg.d_ff} route={route}: ms "
            f"{ms:.5f} (cold; before {BEFORE_MS[label]}) | plain "
            f"{plain_ms:.5f} (cold) | eager call "
            f"(host included) {host_ms:.5f} | bound {bound_ms:.5f} "
            f"({bound_by}: {nbytes / 1e6:.2f} MB) | "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        results.append(dict(shape=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            eager_ms=host_ms))
        del sets
        torch.cuda.empty_cache()
    # 16 slots: two launches of the 8-slot instantiation on the slots'
    # halves, into outputs allocated once; each half bitwise the 8-slot
    # call on its slots alone
    for route in ("bf16", "int8", "int4"):
        quant = (QS, route, cfg.xpeft.quant_group) if route != "bf16" \
            else None
        sets = dec_inputs(torch, gen, cfg, cfg.num_kv_heads, B=16,
                          quant=quant, pos=DEC_POS16)
        rkw = dict(kw, adapter=route)
        label = f"B=16 KV={cfg.num_kv_heads} route={route}"
        err = check_dec(torch, KD, ref, sets[0], rkw, label)
        n0 = KD.decode_block_fused.launches
        whole = KD.decode_block_fused(*sets[0], **rkw)
        per_call = KD.decode_block_fused.launches - n0
        assert per_call == len(KD.slot_groups(16)) == 2, per_call
        x, pos, block, kc, vc, masks_l = sets[0]
        for g in KD.slot_groups(16):
            part = KD.decode_block_fused(
                x[g], pos[g], block, kc[g], vc[g],
                {k: v[g] for k, v in masks_l.items()}, **rkw)
            assert all(torch.equal(a[g], b) for a, b in zip(whole, part)), \
                (label, g)
        ms = device_ms(torch, rotating(
            lambda *a: KD.decode_block_fused(*a, **rkw), sets),
            calls=len(sets))
        plain_ms = device_ms(torch, rotating(
            lambda *a: ref.decode_block_ref(*a, **rkw), sets),
            calls=len(sets))
        nbytes = dec_bytes(sets[0], route)
        bound_ms, bound_by = bound(nbytes, dec_flops(sets[0], route),
                                   "bfloat16")
        log(f"decode_block_fused B=16 S=128 d={cfg.d_model} route={route}: "
            f"{per_call} launches a call, each 8-slot half bitwise the "
            f"8-slot call on its slots | ms {ms:.5f} (cold) | plain "
            f"{plain_ms:.5f} (cold) | bound {bound_ms:.5f} ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB, the layer's weights read once)")
        results.append(dict(shape=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            launches_per_call=per_call))
        del sets, whole
        torch.cuda.empty_cache()
    # the instantiation for 5 to 8 slots (an engine with max_slots 8),
    # checked only: the serve path runs 4
    for route in ("bf16", "int8", "int4"):
        quant = (QS, route, cfg.xpeft.quant_group) if route != "bf16" \
            else None
        sets = dec_inputs(torch, gen, cfg, cfg.num_kv_heads, L=1, B=8,
                          quant=quant)
        check_dec(torch, KD, ref, sets[0], dict(kw, adapter=route),
                  f"B=8 KV={cfg.num_kv_heads} route={route}")
    # the one int4 check at quant_group=16
    sets = dec_inputs(torch, gen, cfg, cfg.num_kv_heads, L=1,
                      quant=(QS,) + QUANT_G16)
    check_dec(torch, KD, ref, sets[0], dict(kw, adapter="int4"),
              f"KV={cfg.num_kv_heads} route=int4 group 16")
    return results


# ----------------------------------------------------------------------------
# phase 3e: the quantized-bank kernels (#5, #6, #8 routes int8/int4)
# ----------------------------------------------------------------------------

# (scheme, int4 group) of the timed kernel checks; QUANT_G16 is the one
# extra int4 check at quant_group=16 per kernel
QUANT_CASES = (("int8", 32), ("int4", 32))
QUANT_G16 = ("int4", 16)


def phase_mask_aggregate_quant(torch, KAQ, ref, QS):
    """#5 at admission's shapes: the layer-folded bank [24*256, ...] of
    each side quantized, P = 96 profile-rows of k = 50 adapters; int4 at
    groups of 16 and of 8 (whose 16-column runs cross scale groups: the
    kernel's per-byte scale path) checked only."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    results = []
    cases = [(sc, g, side) for sc, g in QUANT_CASES
             for side in ("A_hat", "B_hat")] + [QUANT_G16 + ("A_hat",)] \
        + [("int4", 8, "A_hat")]  # groups of 8: #5's per-byte scale path
    for scheme, group, label in cases:
        d, b = (1024, 64) if label == "A_hat" else (64, 1024)
        bank, idx, w = agg_inputs(torch, gen, d, b)
        rec = QS.quantize(bank, scheme, group=group)
        q, sc = rec["q"], rec["scale"]
        del bank, rec
        P, k = idx.shape
        got = KAQ.mask_aggregate_quant_batched(q, sc, idx, w, scheme=scheme)
        want = ref.mask_aggregate_quant_batched_ref(q, sc, idx, w,
                                                    scheme=scheme)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (P, d, b)
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        # one nonzero weight per row: each dequantized term alone
        hot = torch.zeros_like(w)
        hot[torch.arange(P), torch.randint(0, k, (P,), generator=gen,
                                           device="cuda")] = 0.73
        term_eq = torch.equal(
            KAQ.mask_aggregate_quant_batched(q, sc, idx, hot, scheme=scheme),
            ref.mask_aggregate_quant_batched_ref(q, sc, idx, hot,
                                                 scheme=scheme))
        pad = KAQ.mask_aggregate_quant_batched(
            q, sc, torch.zeros_like(idx[:2]), torch.zeros_like(w[:2]),
            scheme=scheme)
        tag = f"{scheme} g{group} {label}"
        log(f"mask_aggregate_quant_batched[{tag}] P={P} k={k} q "
            f"{tuple(q.shape)} {q.dtype}, scales {tuple(sc.shape)}: "
            f"max_abs_err {err:.3e} (bitwise {torch.equal(got, want)}; atol "
            f"{AGG_ATOL}); one-hot terms bitwise {term_eq}")
        assert err <= AGG_ATOL and term_eq, (tag, err)
        assert not pad.abs().max().item()
        if group < 32:
            continue  # checked only
        # the quantized bank (201-403 MB) holds each call's 100-300 MB of
        # selected rows far past the 50 MB L2: graph replays find them cold
        ms = device_ms(torch, lambda: KAQ.mask_aggregate_quant_batched(
            q, sc, idx, w, scheme=scheme), calls=8)
        host_ms = eager_ms(torch, lambda: KAQ.mask_aggregate_quant_batched(
            q, sc, idx, w, scheme=scheme), calls=3)
        plain_ms = eager_ms(
            torch, lambda: ref.mask_aggregate_quant_batched_ref(
                q, sc, idx, w, scheme=scheme), calls=1)
        uniq = int(torch.unique(idx).numel())
        row = (q[0].numel() * q.element_size()
               + sc[0].numel() * sc.element_size())
        nbytes = uniq * row + idx.numel() * 4 + w.numel() * 4 + P * d * b * 4
        bound_ms, bound_by = bound(nbytes, 2 * P * k * d * b, "float32")
        log(f"  ms {ms:.5f} (cold graph replay; before "
            f"{BEFORE_MS[tag + ' replay']}) | eager {host_ms:.4f} | plain "
            f"{plain_ms:.4f} | bound {bound_ms:.5f} ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {uniq} distinct rows) | "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
        results.append(dict(shape=f"{scheme} {label}", max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            eager_ms=host_ms))
        del q, sc, got, want
        torch.cuda.empty_cache()
    return results


def quant_records(QS, scheme, group, a, b):
    """Per-row quantized Â/B̂ records {a_q, a_scale, b_q, b_scale} of a
    [..., d, b] / [..., b, d] pair, as the engine's slot buffers hold
    them."""
    qa = QS.quantize(a, scheme, group=group)
    qb = QS.quantize(b, scheme, group=group)
    return {"a_q": qa["q"], "a_scale": qa["scale"], "b_q": qb["q"],
            "b_scale": qb["scale"]}


def fa_quant_inputs(torch, gen, QS, scheme, group, B, T, d, b, dtype, L=1):
    """x [B, T, d] and one layer of [B, L, ...] quantized slot records
    (strided row slices, as the model passes them), with LN affines."""
    x, a, bb, ls, lb = fa_inputs(torch, gen, B * L, T, d, b, torch.float32)
    rec = quant_records(QS, scheme, group,
                        a.view(B, L, d, b), bb.view(B, L, b, d))
    l = L // 2
    return (x[:B].to(dtype), rec["a_q"][:, l], rec["a_scale"][:, l],
            rec["b_q"][:, l], rec["b_scale"][:, l],
            ls.view(B, L, b)[:, l], lb.view(B, L, b)[:, l])


def check_faq(torch, KFQ, ref, args, scheme, rtol, atol, label):
    got = KFQ.fused_adapter_quant_batched(*args, scheme=scheme)
    want = ref.fused_adapter_quant_batched_ref(*args, scheme=scheme)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= rtol * want.float().abs() + atol).all())
    log(f"  check {label}: max_abs_err {err:.3e} ok={ok}")
    assert ok, label
    return err


def phase_fused_adapter_quant(torch, KFQ, ref, QS):
    """#6 at the serving shapes: B=4 slots, d=1024, on layer slices of
    [B, L, ...] quantized records, int8 and int4 at group 32 (int4 also at
    16): fp32 x at T=1 and 16; bf16 x at T=1, 5, 16, 17 and 128 (b=64)
    and at b=32 and 128 (T=1 and 16); clusters of 16 where the planner
    takes them; two calls bitwise equal. Timed at T=1 (decode), T=16
    (prefill) and, int8, T=128."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, d, b = 4, 1024, 64
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(scheme, group, T, dtype, nb=b, dw=d):
        return fa_quant_inputs(torch, gen, QS, scheme, group, B, T, dw, nb,
                               dtype, L=3)

    for scheme, group in QUANT_CASES + (QUANT_G16,):
        for T in (1, 16):
            check_faq(torch, KFQ, ref, inputs(scheme, group, T, f32),
                      scheme, FA_F32_RTOL, FA_F32_ATOL,
                      f"{scheme} g{group} fp32 x, layer slice T={T}")
        if (scheme, group) == QUANT_G16:
            continue  # checked only
        # T that is not a whole 16-token tile, and several tiles
        for T in (5, 17, 128):
            check_faq(torch, KFQ, ref, inputs(scheme, group, T, bf16),
                      scheme, FA_BF16_RTOL, FA_BF16_ATOL,
                      f"{scheme} bf16 layer slice T={T}")
        # other bottleneck widths
        for nb in (32, 128):
            for T in (1, 16):
                check_faq(torch, KFQ, ref,
                          inputs(scheme, group, T, bf16, nb=nb), scheme,
                          FA_BF16_RTOL, FA_BF16_ATOL,
                          f"{scheme} bf16 b={nb} T={T}")
        # the cluster's partials are summed in rank order: two calls on
        # the same inputs agree bit for bit
        for T in (1, 16):
            args = inputs(scheme, group, T, bf16)
            first = KFQ.fused_adapter_quant_batched(*args, scheme=scheme)
            second = KFQ.fused_adapter_quant_batched(*args, scheme=scheme)
            torch.cuda.synchronize()
            log(f"  check two calls {scheme} bf16 T={T}: bitwise "
                f"{torch.equal(first, second)}")
            assert torch.equal(first, second), (scheme, T)
    # clusters of 16 blocks, where the planner takes them: decode of a
    # 7168-wide model (llava-next-34b) and prefill of a 6144-wide one
    # (dbrx-132b), whose fp32 tiles overflow a block's shared memory at 8
    for scheme, dw, T in (("int8", 7168, 1), ("int4", 6144, 16)):
        args = inputs(scheme, 32, T, bf16, dw=dw)
        groups = KFQ._check(*args, scheme, "gelu")[1]
        cs = KFQ.plan(dw, b, T, 2, scheme, *groups)
        assert cs == 16, (scheme, dw, T, cs)
        check_faq(torch, KFQ, ref, args, scheme, FA_BF16_RTOL, FA_BF16_ATOL,
                  f"{scheme} bf16 d={dw} T={T}, clusters of {cs}")
    # the int4 tile in two passes (gemma3-27b's d=5376, forms (b)) against
    # the one-pass tile where both fit: the same products in the same
    # order, bitwise
    for T, dtype in ((1, bf16), (16, bf16), (16, f32)):
        args = inputs("int4", 32, T, dtype)
        one, two = (KFQ._launch(*args, scheme="int4", activation="gelu",
                                passes=n) for n in (1, 2))
        torch.cuda.synchronize()
        log(f"  check int4 T={T} {dtype}: two passes over the tile bitwise "
            f"one pass {torch.equal(one, two)}")
        assert torch.equal(one, two), T

    results = []
    for scheme, group in QUANT_CASES:
        for T in (1, 16, 128) if scheme == "int8" else (1, 16):
            sets = [inputs(scheme, group, T, bf16) for _ in range(64)]
            err = check_faq(torch, KFQ, ref, sets[0], scheme, FA_BF16_RTOL,
                            FA_BF16_ATOL, f"{scheme} bf16 layer slice T={T}")
            fn = lambda *a: KFQ.fused_adapter_quant_batched(  # noqa: E731
                *a, scheme=scheme)
            plain = lambda *a: ref.fused_adapter_quant_batched_ref(  # noqa
                *a, scheme=scheme)
            ms = device_ms(torch, rotating(fn, sets), calls=len(sets))
            plain_ms = device_ms(torch, rotating(plain, sets),
                                 calls=len(sets))
            x = sets[0][0]
            # x read, y written, the slots' records and LN affines read
            nbytes = 2 * x.numel() * x.element_size() + sum(
                t[0].numel() * t.element_size() * B for t in sets[0][1:])
            bound_ms, bound_by = bound(nbytes, 4 * B * T * d * b,
                                       "bfloat16")
            before = BEFORE_MS.get(f"{scheme} T={T}", "not timed")
            log(f"fused_adapter_quant_batched {scheme} B={B} T={T} d={d} "
                f"b={b}: ms {ms:.5f} (cold; before {before}) | plain "
                f"{plain_ms:.5f} (cold) | bound {bound_ms:.5f} ({bound_by}: "
                f"{nbytes / 1e6:.3f} MB)")
            results.append(dict(shape=f"{scheme} T={T}", max_abs_err=err,
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None))
            del sets
    return results


def faq_slice_rows(torch, KFQ, ref, QS, gen, name, scheme, d, nb, L, Ts,
                   B=4):
    """#6 at bf16 x on layer slices of [B, 3, ...] quantized records at
    each T of ``Ts``: checked within #2's bounds, two calls bitwise equal,
    timed as cold CUDA-graph replays rotating over L sets, beside the
    plain version and the bound of one call's bytes."""
    rows = []
    for T in Ts:
        sets = [fa_quant_inputs(torch, gen, QS, scheme, 32, B, T, d, nb,
                                torch.bfloat16, L=3) for _ in range(L)]
        tag = f"{name} {scheme} B={B} T={T} d={d} b={nb}"
        groups = KFQ._check(*sets[0], scheme, "gelu")[1]
        cs_, passes = KFQ.launch_plan(d, nb, T, 2, scheme, *groups)
        err = check_faq(torch, KFQ, ref, sets[0], scheme, FA_BF16_RTOL,
                        FA_BF16_ATOL, f"{tag}, clusters of {cs_}, "
                        f"{passes} pass(es) over the tile")
        first = KFQ.fused_adapter_quant_batched(*sets[0], scheme=scheme)
        second = KFQ.fused_adapter_quant_batched(*sets[0], scheme=scheme)
        torch.cuda.synchronize()
        assert torch.equal(first, second), tag
        fn = lambda *a: KFQ.fused_adapter_quant_batched(  # noqa: E731
            *a, scheme=scheme)
        plain = lambda *a: ref.fused_adapter_quant_batched_ref(  # noqa
            *a, scheme=scheme)
        ms = device_ms(torch, rotating(fn, sets), calls=len(sets))
        plain_ms = device_ms(torch, rotating(plain, sets), calls=len(sets))
        x = sets[0][0]
        nbytes = 2 * x.numel() * x.element_size() + sum(
            t[0].numel() * t.element_size() * B for t in sets[0][1:])
        bound_ms, bound_by = bound(nbytes, 4 * B * T * d * nb, "bfloat16")
        log(f"fused_adapter_quant_batched {tag}: ms {ms:.5f} (cold) | "
            f"plain {plain_ms:.5f} (cold) | bound {bound_ms:.5f} "
            f"({bound_by}: {nbytes / 1e6:.3f} MB); two calls bitwise")
        rows.append(dict(shape=tag, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         cluster=cs_, passes=passes))
        del sets, first, second
    return rows


# ----------------------------------------------------------------------------
# phase 3d: the unbatched adapter (#3) and one-profile aggregation (#4)
# ----------------------------------------------------------------------------

def phase_unbatched(torch, KA, KF1, ref, F):
    gen = torch.Generator(device="cuda").manual_seed(4)
    results = {}
    # 3: x [256, 1024] bf16 through one shared A_hat/B_hat (b=64)
    T, d, b = 256, 1024, 64
    sets = [tuple(t[0] if i == 0 else t for i, t in enumerate(
        fa_inputs(torch, gen, 1, T, d, b, torch.bfloat16, shared=True)))
        for _ in range(64)]
    got = KF1.fused_adapter(*sets[0])
    want = ref.fused_adapter_ref(*sets[0])
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= FA_BF16_RTOL * want.float().abs()
               + FA_BF16_ATOL).all())
    again = KF1.fused_adapter(*sets[0])
    torch.cuda.synchronize()
    log(f"fused_adapter (unbatched) T={T} d={d} b={b} bf16: max_abs_err "
        f"{err:.3e} ok={ok}; two calls bitwise {torch.equal(got, again)}")
    assert ok and got.shape == (T, d) and torch.equal(got, again)
    ms = device_ms(torch, rotating(KF1.fused_adapter, sets), calls=len(sets))
    plain_ms = device_ms(torch, rotating(ref.fused_adapter_ref, sets),
                         calls=len(sets))
    nbytes = sum(t.numel() * t.element_size() for t in sets[0]) \
        + sets[0][0].numel() * 2
    bound_ms, bound_by = bound(nbytes, 4 * T * d * b, "bfloat16")
    log(f"  ms {ms:.5f} (cold; before {BEFORE_MS['unbatched T=256']}) | "
        f"plain {plain_ms:.5f} (cold) | bound {bound_ms:.5f} ({bound_by}: "
        f"{nbytes / 1e6:.3f} MB)")
    results["fused_adapter"] = dict(
        shape=f"T={T}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    del sets

    # 4: bank [256, 1024, 64] bf16, one profile's k=50 rows
    N, k = 256, 50
    bank = (torch.randn((N, d, b), generator=gen, device="cuda")
            * 0.05).to(torch.bfloat16)
    idx = torch.rand((N,), generator=gen, device="cuda").argsort()[:k]
    idx = idx.sort().values.to(torch.int32).contiguous()
    w = torch.full((k,), 1.0 / k, dtype=torch.float32, device="cuda")
    got = KA.mask_aggregate(bank, idx, w)
    want = ref.mask_aggregate_ref(bank, idx, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"mask_aggregate (one profile) bank {tuple(bank.shape)} k={k} "
        f"bf16: max_abs_err {err:.3e} (bitwise {torch.equal(got, want)}; "
        f"atol {AGG_ATOL})")
    assert err <= AGG_ATOL and got.shape == (d, b)
    # the bank (32 MB) would sit in the 50 MB L2 between calls; rotate
    # over 8 banks so each call reads its k rows from HBM
    banks = [bank] + [(torch.randn((N, d, b), generator=gen, device="cuda")
                       * 0.05).to(torch.bfloat16) for _ in range(7)]
    sets = [(bk, idx, w) for bk in banks]
    ms = device_ms(torch, rotating(KA.mask_aggregate, sets), calls=64)
    plain_ms = device_ms(torch, rotating(ref.mask_aggregate_ref, sets),
                         calls=8)
    flats = [(idx[None], bk.view(N, -1), w[None].to(bk.dtype))
             for bk in banks]
    lib_ms = device_ms(torch, rotating(
        lambda i, fl, ww: F.embedding_bag(i, fl, per_sample_weights=ww,
                                          mode="sum"), flats), calls=64)
    nbytes = k * d * b * 2 + k * 8 + d * b * 4
    bound_ms, bound_by = bound(nbytes, 2 * k * d * b, "float32")
    log(f"  ms {ms:.5f} (cold; before {BEFORE_MS['one profile']}) | plain "
        f"{plain_ms:.5f} | embedding_bag {lib_ms:.5f} (kernel faster: "
        f"{ms < lib_ms}) | bound {bound_ms:.5f} ({bound_by}: "
        f"{nbytes / 1e6:.2f} MB)")
    results["mask_aggregate"] = dict(
        shape=f"N={N} k={k}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
    del banks, sets, flats, bank
    torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------------
# phase 4: serve
# ----------------------------------------------------------------------------

def make_requests(Request, vocab, n=8, max_new=16, profiles=4):
    """n requests of 4-16 prompt tokens from seed 0; request i serves
    profile i % profiles, or profiles[i % len(profiles)] for a list."""
    import numpy as np
    rng = np.random.default_rng(0)
    pids = list(range(profiles)) if isinstance(profiles, int) else \
        list(profiles)
    return [Request(uid=i, prompt=rng.integers(0, vocab,
                                               size=rng.integers(4, 17)),
                    profile_id=pids[i % len(pids)], max_new_tokens=max_new)
            for i in range(n)]


def prefill_logits(torch, eng, reqs, bare=False):
    """The engine's own prefill of every request (one padded bucket) with
    the aggregated entries its admission left in the profile cache (a
    prefix-bearing bank's rows written in front of each prefix-on prompt,
    as admission writes them), or with no adapter (``bare``)."""
    pad = 16
    toks = torch.zeros((len(reqs), pad), dtype=torch.int32)
    lens = torch.tensor([len(r.prompt) for r in reqs], dtype=torch.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = torch.from_numpy(r.prompt)
    if bare:
        logits, _ = eng.prefill_logits(toks.to(eng.device), None,
                                       lens.to(eng.device))
        return logits
    if not eng.precompute:
        # per-step serving: the store's weights, as admission hydrates them
        masks = dict(zip(eng._entry_keys, (
            t.to(eng.device) for t in eng.store.batch_mask_weights(
                [r.profile_id for r in reqs]))))
        logits, _ = eng.prefill_logits(toks.to(eng.device), masks,
                                       lens.to(eng.device))
        return logits
    rows = [eng.profile_cache.peek(r.profile_id) for r in reqs]
    masks = {k: torch.stack([row[k] for row in rows])
             for k in eng._entry_keys}
    cpos = prows = None
    if eng.prefix_len:
        prows = (masks.pop("prefix_k"), masks.pop("prefix_v"))
        cpos = torch.tensor([r.prefix_len for r in reqs], dtype=torch.int32,
                            device=eng.device)
    logits, _ = eng.prefill_logits(toks.to(eng.device), masks,
                                   lens.to(eng.device), cpos, prows)
    return logits


def forced_decode(torch, MDL, ServeEngine, Request, run_cfg, params, store,
                  reqs, forced, bare=False, eng_kw=None, prefill_out=None):
    """Decode-step logits [R, n-1, V] of a fresh engine serving ``reqs``
    as the free runs do (one engine, 4 slots, the scheduler's own
    admission waves, so every prefill batch is the free run's), each
    slot's step fed the token ``forced[uid]`` holds at that step (teacher
    forcing) instead of its own greedy pick. The model call is the
    engine's decode step with the logits kept (``bare``: with the adapter
    left out; ``eng_kw``: more engine options, e.g. precompute). With
    ``prefill_out`` (a dict), each request's prefill logits [V], as its
    admission wave computed them, are kept there by uid."""
    eng = ServeEngine(run_cfg, params, store, max_slots=4, max_seq=128,
                      sync_every=8, **(eng_kw or {}))
    if prefill_out is not None:
        # admission prefills the groups of group_by_bucket in sorted
        # order, one prefill_logits call each, row j for group[j]
        groups = []
        group_by_bucket = eng.scheduler.group_by_bucket
        prefill = eng.prefill_logits

        def spy_groups(wave):
            out = group_by_bucket(wave)
            groups.extend(out[pad] for pad in sorted(out))
            return out

        def spy_prefill(*args, **kwargs):
            logits, mini = prefill(*args, **kwargs)
            for j, r in enumerate(groups.pop(0)):
                prefill_out[r.uid] = logits[j]
            return logits, mini
        eng.scheduler.group_by_bucket = spy_groups
        eng.prefill_logits = spy_prefill
    dev = params["embed"].device
    n = len(forced[reqs[0].uid]) - 1
    rows = {r.uid: [] for r in reqs}

    def decode_fn(params, cache, last_tok, lengths, masks, active):
        live = [(i, r.uid) for i, r in enumerate(eng.slot_req)
                if r is not None and len(rows[r.uid]) < n]
        feed, nxt = last_tok.clone(), last_tok.clone()
        for i, uid in live:
            s = len(rows[uid])
            feed[i] = forced[uid][s]
            nxt[i] = forced[uid][s + 1]
        hidden, cache, _ = MDL.forward(
            params, feed[:, None], run_cfg,
            profile_masks=None if bare else masks, cache=cache,
            cache_pos=lengths)
        logits = MDL.lm_logits(params, hidden, run_cfg)[:, -1]
        for i, uid in live:
            rows[uid].append(logits[i])
        return nxt, cache

    eng.slots.decode_fn = decode_fn
    eng.run_until_drained([Request(uid=r.uid, prompt=r.prompt,
                                   profile_id=r.profile_id,
                                   max_new_tokens=r.max_new_tokens)
                           for r in reqs])
    assert all(len(v) == n for v in rows.values())
    return torch.stack([torch.stack(rows[r.uid]) for r in reqs]).to(dev)


def bf16_step(v):
    """Spacing of bf16 values at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def e2e_check(label, got, want, bare, report_share=False, witness=None):
    """Kernel-run logits against the ref run's, within E2E_STEPS bf16
    steps and E2E_SHARE_REL of the adapters' share of the logits (with
    ``report_share``, a reading over the share bound is reported, not
    asserted). ``witness``, where given, sets the steps bound to twice
    it: W, the ref run's own max |d logit| from the same run in float32
    on the same inputs, for a model whose largest logit is small against
    the bf16 noise its depth gathers. A kernel run no further from
    float32 than the ref run is lies within 2W of the ref run (triangle
    inequality)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    share = (want - bare).abs().max().item()
    tol = E2E_STEPS * bf16_step(scale) if witness is None else 2 * witness
    ratio = err / share if share else math.inf
    met = err <= E2E_SHARE_REL * share
    log(f"  {label}: kernel vs ref max|d logit| {err:.4e}; max|logit| "
        f"{scale:.4f} (bf16 step {bf16_step(scale):.4e}, tol {tol:.4e}"
        + ("" if witness is None else f": twice the ref run's own "
           f"max|d logit| from float32, {witness:.4e}")
        + f"); adapters' share max|ref - no adapter| {share:.4e} "
        f"(err/share {ratio:.4e}, tol {E2E_SHARE_REL})"
        + ("" if met else " -- EXCEEDS the E2E_SHARE_REL bound"))
    assert err <= tol, (label, err, tol)
    assert met or report_share, (label, err, share)
    return dict(max_abs_err=err, max_logit=scale, adapter_share=share,
                share_ratio=ratio, share_bound_met=met, tol=tol,
                witness=witness)


def explain_divergence(torch, reqs, ref_reqs, pre, dec):
    """For each request whose greedy tokens part between the kernel and
    ref runs, the first token where they part: the ref run's top-2 gap
    there must be within twice that step's max |d logit| (``pre`` /
    ``dec`` hold (kernel, ref) prefill and teacher-forced decode logits;
    up to that token both runs saw the same history, so the teacher-
    forced logits are the free runs' own)."""
    agree = total = 0
    for i, (r, q) in enumerate(zip(reqs, ref_reqs)):
        assert r.uid == q.uid
        pairs = list(zip(r.generated, q.generated))
        agree += sum(a == b for a, b in pairs)
        total += len(pairs)
        j = next((t for t, (a, b) in enumerate(pairs) if a != b), None)
        if j is None:
            continue
        where, (lk, lr) = ("prefill", (pre[0][i], pre[1][i])) if j == 0 \
            else (f"decode step {j - 1}", (dec[0][i, j - 1], dec[1][i, j - 1]))
        top = lr.topk(2)
        gap = (top.values[0] - top.values[1]).item()
        d = (lk - lr).abs().max().item()
        a, b = (int(t) for t in top.indices)
        log(f"  first greedy divergence: request {r.uid}, generated token "
            f"{j} ({where}): ref picks {q.generated[j]}, kernel picks "
            f"{r.generated[j]}; ref top-2 {a}/{b} gap {gap:.4e}, kernel "
            f"there {lk[a].item():.4f}/{lk[b].item():.4f} vs ref "
            f"{lr[a].item():.4f}/{lr[b].item():.4f}; the step's max|d logit| "
            f"{d:.4e}")
        assert int(lk.argmax()) == r.generated[j], (r.uid, j)
        assert int(lr.argmax()) == q.generated[j], (r.uid, j)
        assert gap <= 2 * d, (r.uid, j, gap, d)
    return agree, total


def serve_once(torch, cfg, params, store, reqs, eng_kw=None):
    """Drain ``reqs`` on a fresh engine (4 slots, max_seq 128, sync_every
    8, and ``eng_kw``): (engine, engine steps, seconds, each wave's
    last_admission)."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, store, max_slots=4, max_seq=128,
                      sync_every=8, **(eng_kw or {}))
    waves = []
    hydrate = eng._hydrate_stacked

    def spy(wave):
        out = hydrate(wave)
        waves.append(dict(eng.last_admission))
        return out
    eng._hydrate_stacked = spy
    torch.cuda.synchronize()
    t = time.perf_counter()
    steps = eng.run_until_drained(list(reqs))
    torch.cuda.synchronize()
    return eng, steps, time.perf_counter() - t, waves


def drive_path(torch, label, cfg, params, store, counters, check_launches,
               check_runs=None, report_share=False, eng_kw=None,
               ref_kw=None, own_prefill=False, profiles=4, witness=None,
               profile=True):
    """One serving path end to end: a warm-up drain, then the 8 requests
    with every counter in ``counters`` set to 0 just before
    (``check_launches(launches, serve_stats, waves)`` asserts what must
    have launched), their kernel_impl="ref" rerun (nothing may launch;
    ``check_runs(kernel_engine, ref_engine)`` compares what admission left
    in each), the prefill and teacher-forced decode-step logits held to
    the ref run, every greedy flip explained, and a profiled decode
    step (unless ``profile`` is False). ``eng_kw`` are the path's engine
    options, ``ref_kw`` the ref
    run's (default: the same); ``own_prefill`` holds the prefill logits
    the teacher-forced runs' own admission waves computed, in place of
    one padded bucket of all 8 requests. ``profiles``: the requests'
    profiles, as ``make_requests`` takes them. ``witness(ref_engine,
    ref_requests)``, where given, returns (W_prefill, W_decode), the ref
    run's own max |d logit| from the same run in float32, and the logits
    are held within twice it (``e2e_check``'s witness bound), for a model
    whose bf16 noise is above E2E_STEPS."""
    ref_kw = eng_kw if ref_kw is None else ref_kw
    from repro_torch.models import model as MDL
    from repro_torch.serve import Request, ServeEngine

    serve_once(torch, cfg, params, store,
               make_requests(Request, cfg.vocab_size, n=4, max_new=4,
                             profiles=profiles), eng_kw)
    torch.cuda.reset_peak_memory_stats()
    reqs = make_requests(Request, cfg.vocab_size, profiles=profiles)
    for _, fn in counters:
        fn.launches = 0
    eng, steps, dt, waves = serve_once(torch, cfg, params, store, reqs,
                                       eng_kw)
    launches = {name: fn.launches for name, fn in counters}
    toks = sum(len(r.generated) for r in reqs)
    st = eng.serve_stats()
    log(f"serve {label} (kernels): {len(reqs)} requests / {toks} tokens in "
        f"{steps} engine steps, {dt:.3f}s = {toks / dt:.1f} tok/s; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  stats: host_syncs {st['host_syncs']}, device_steps "
        f"{st['device_steps']}, decode_tokens {st['decode_tokens']}, "
        f"prefill_batches {st['prefill_batches']}, prefill_occupancy "
        f"{st['prefill_occupancy']}, cache hit rate "
        f"{st['profile_cache']['hit_rate']}, syncs/token "
        f"{st['syncs_per_token']}, bank_quant {st['bank_quant']}")
    for wave in waves:
        log(f"  admission: path {wave['path']}, hits {wave['cache_hits']}, "
            f"misses {wave['cache_misses']}, aggregated "
            f"{wave.get('aggregated_profiles', 0)}, store-hydrated "
            f"{wave.get('store_hydrated_profiles', 0)}, bank bytes/request "
            f"{wave['bank_bytes_per_request']}")
    assert all(r.done and len(r.generated) == 16 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    check_launches(launches, st, waves)

    ref_cfg = cfg.with_xpeft(kernel_impl="ref")
    ref_reqs = make_requests(Request, cfg.vocab_size, profiles=profiles)
    for _, fn in counters:
        fn.launches = 0
    ref_eng, _, ref_dt, _ = serve_once(torch, ref_cfg, params, store,
                                       ref_reqs, ref_kw)
    assert not any(fn.launches for _, fn in counters)
    ref_toks = sum(len(r.generated) for r in ref_reqs)
    log(f"serve {label} (kernel_impl=ref): {ref_toks} tokens, "
        f"{ref_dt:.3f}s = {ref_toks / ref_dt:.1f} tok/s")
    if check_runs is not None:
        check_runs(eng, ref_eng)
    w_pre = w_dec = None
    if witness is not None:
        w_pre, w_dec = witness(ref_eng, ref_reqs)

    def check_prefill(pre):
        assert torch.isfinite(pre[0]).all()
        assert pre[0].shape == (8, cfg.vocab_size)
        e2e_check("prefill logits", *pre,
                  prefill_logits(torch, ref_eng, ref_reqs, bare=True),
                  witness=w_pre)

    if not own_prefill:
        pre = [prefill_logits(torch, e, rs) for e, rs in
               ((eng, reqs), (ref_eng, ref_reqs))]
        check_prefill(pre)
    forced = {q.uid: q.generated for q in ref_reqs}
    seen = ({}, {}, None) if own_prefill else (None, None, None)
    dec = [forced_decode(torch, MDL, ServeEngine, Request, c, params, store,
                         reqs, forced, bare=bare, eng_kw=kw, prefill_out=po)
           for (c, bare, kw), po in zip(
               ((cfg, False, eng_kw), (ref_cfg, False, ref_kw),
                (ref_cfg, True, ref_kw)), seen)]
    if own_prefill:
        # the prefill logits of the runs' own admission waves: the
        # per-step aggregation is a skinny GEMM whose rounding follows the
        # batch's row count, so one bucket of all 8 would not be the
        # free run's prefill
        pre = [torch.stack([d[r.uid] for r in reqs]) for d in seen[:2]]
        check_prefill(pre)
    assert torch.isfinite(dec[0]).all()
    assert dec[0].shape == (8, 15, cfg.vocab_size)
    ref_tokens = torch.tensor([q.generated[1:] for q in ref_reqs],
                              device=dec[1].device)
    replay = (dec[1].argmax(-1) == ref_tokens).sum().item()
    log(f"  teacher-forced ref decode reproduces {replay}/"
        f"{ref_tokens.numel()} of the ref run's decode tokens")
    # explain_divergence's premise: the teacher-forced logits are the free
    # runs' own
    assert replay == ref_tokens.numel(), replay
    e2e = e2e_check(f"{label} decode-step logits, teacher-forced (8 "
                    "requests x 15 steps)", *dec, report_share=report_share,
                    witness=w_dec)
    agree, total = explain_divergence(torch, reqs, ref_reqs, pre, dec[:2])
    log(f"  greedy tokens agree {agree / total:.3f} ({agree}/{total})")
    extra = {}
    if report_share:
        # the same teacher-forced decode steps with the adapter left out
        # of the kernel run too (prefill keeps it): what the prefill's
        # adapter kernel and, with decode_fused, the megakernel's other
        # phases make of the difference
        bare_k = forced_decode(torch, MDL, ServeEngine, Request, cfg, params,
                               store, reqs, forced, bare=True, eng_kw=eng_kw)
        extra["bare_decode_logit_err"] = (bare_k - dec[2]).abs().max().item()
        log(f"  decode steps with the adapter left out of both runs "
            f"(prefill keeps it): kernel vs ref max|d logit| "
            f"{extra['bare_decode_logit_err']:.4e}")
    step = profile_decode(torch, ServeEngine, Request, cfg, params, store,
                          label, eng_kw, profiles=profiles) if profile else {}
    return eng, reqs, launches, dict(
        tok_s=toks / dt, ref_tok_s=ref_toks / ref_dt,
        greedy_agree_ref=agree / total, decode_logit_err=e2e["max_abs_err"],
        adapter_share=e2e["adapter_share"], share_ratio=e2e["share_ratio"],
        share_bound_met=e2e["share_bound_met"], admissions=waves, **extra,
        **step)


def phase_serve(torch, KA, KF):
    """qwen1.5-0.5b at full width, bf16 bank, the composed decode path:
    the aggregation (#1) at admission, the fused adapter (#2) in every
    layer of every prefill and decode step."""
    from repro_torch.configs import get_config
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.models import init_lm

    cfg = get_config("qwen1.5-0.5b")
    xp = cfg.xpeft
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for k, v in params.items()
                   if k not in ("blocks", "final_norm", "xpeft_bank"))
    n_params += sum(v.numel() for sub in params["blocks"].values()
                    for v in sub.values())
    n_bank = sum(v.numel() for v in params["xpeft_bank"].values())
    log(f"serve: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
        f"H={cfg.num_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
        f"V={cfg.vocab_size} {cfg.dtype}; bank N={xp.num_adapters} "
        f"b={xp.bottleneck} k={xp.k}; {n_params / 1e6:.1f}M params + "
        f"{n_bank / 1e6:.1f}M bank values, init "
        f"{time.perf_counter() - t0:.2f}s")
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k)
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=4), seed=0)
    for pid in range(4):
        store.add_profile(pid, {k: v[pid] for k, v in table.items()})

    def check_launches(launches, st, waves):
        assert launches["mask_aggregate_batched"] > 0, launches
        assert launches["fused_adapter_batched"] > 0, launches

    def check_runs(eng, ref_eng):
        bitwise = True
        for pid in range(4):
            a = eng.profile_cache.peek(pid)
            b = ref_eng.profile_cache.peek(pid)
            for key in a:
                bitwise &= torch.equal(a[key], b[key])
                gap = (a[key].float() - b[key].float()).abs()
                assert (gap <= 2.0 ** -7 * b[key].float().abs()
                        + 1e-6).all()
        log(f"  kernel vs ref: admission aggregates bitwise {bitwise}")

    eng, reqs, launches, stats = drive_path(
        torch, "composed", cfg, params, store,
        (("mask_aggregate_batched", KA.mask_aggregate_batched),
         ("fused_adapter_batched", KF.fused_adapter_batched)),
        check_launches, check_runs)
    ctx = dict(cfg=cfg, params=params, store=store, reqs=reqs, engine=eng,
               table=table)
    return launches, stats, ctx


def phase_entry_points(torch, KA, KF1, ctx):
    """The entry points of TPU kernels #3 and #4, each driven over the 24
    layers of an admitted profile: ``ops.mask_aggregate`` (one profile,
    P=1) must give the engine's batched admission aggregates bit for bit,
    and ``core.xpeft.apply_precomputed_layer`` (x [T, d]) its plain
    version within the fused-adapter tolerance."""
    from repro_torch.core import xpeft as XP
    from repro_torch.kernels import ops

    cfg, params, store = ctx["cfg"], ctx["params"], ctx["store"]
    entry = ctx["engine"].profile_cache.peek(0)
    ia, wa, ib, wb = (t.cuda() for t in store.sparse_indices(0))
    bank = params["xpeft_bank"]
    req = ctx["reqs"][0]
    h = params["embed"][torch.from_numpy(req.prompt).long().cuda()]
    xp, ref_xp = cfg.xpeft, cfg.with_xpeft(kernel_impl="ref").xpeft
    KA.mask_aggregate.launches = 0
    KF1.fused_adapter.launches = 0
    errs, bitwise = [], True
    for l in range(cfg.num_layers):
        for key, bank_l, i, w in (("a_hat", bank["bank_a"][l], ia[l], wa[l]),
                                  ("b_hat", bank["bank_b"][l], ib[l], wb[l])):
            agg = ops.mask_aggregate(bank_l, i.contiguous(), w.contiguous(),
                                     impl=xp.kernel_impl)
            bitwise &= torch.equal(agg.to(entry[key].dtype), entry[key][l])
        eff = {k: v[l] for k, v in entry.items()}
        got = XP.apply_precomputed_layer(h, eff, xp)
        want = XP.apply_precomputed_layer(h, eff, ref_xp)
        diff = (got.float() - want.float()).abs()
        assert (diff <= FA_BF16_RTOL * want.float().abs()
                + FA_BF16_ATOL).all(), l
        errs.append(diff.max().item())
    torch.cuda.synchronize()
    launches = {"mask_aggregate": KA.mask_aggregate.launches,
                "fused_adapter": KF1.fused_adapter.launches}
    log(f"entry points over {cfg.num_layers} layers of profile 0: "
        f"ops.mask_aggregate launches {launches['mask_aggregate']}, equal "
        f"to the admission aggregates bit for bit: {bitwise}; "
        f"apply_precomputed_layer (x [{h.shape[0]}, {h.shape[1]}]) launches "
        f"{launches['fused_adapter']}, max_abs_err vs plain {max(errs):.3e}")
    assert bitwise
    assert launches == {"mask_aggregate": 2 * cfg.num_layers,
                        "fused_adapter": cfg.num_layers}, launches
    return launches


def phase_serve_fused(torch, KA, KF, KD, ctx):
    """The same 8 requests served with ``decode_fused=True``: each decode
    step runs the megakernel once per layer; prefill stays composed (the
    fused adapter) and admission runs the aggregation."""
    cfg = ctx["cfg"].with_(decode_fused=True)
    L = cfg.num_layers

    def check_launches(launches, st, waves):
        assert launches["decode_block_fused"] == L * st["device_steps"] > 0
        assert launches["fused_adapter_batched"] == L * st["prefill_batches"]
        assert launches["mask_aggregate_batched"] > 0, launches

    _, reqs, launches, stats = drive_path(
        torch, "decode_fused", cfg, ctx["params"], ctx["store"],
        (("mask_aggregate_batched", KA.mask_aggregate_batched),
         ("fused_adapter_batched", KF.fused_adapter_batched),
         ("decode_block_fused", KD.decode_block_fused)), check_launches)
    stats["tokens_equal_composed"] = tokens_equal(reqs, ctx["reqs"])
    log(f"  tokens equal to the composed kernel run "
        f"{stats['tokens_equal_composed']:.3f}")
    return launches, stats


def tokens_equal(reqs, other):
    """Share of generated tokens two runs of the same requests agree on."""
    pairs = [(a, b) for r, q in zip(reqs, other)
             for a, b in zip(r.generated, q.generated)]
    return sum(a == b for a, b in pairs) / len(pairs)


def phase_serve_quant(torch, KAQ, KFQ, KD, KA, KF, ctx, scheme, fused):
    """qwen1.5-0.5b served from a quantized bank (``bank_quant`` int8 or
    int4): the engine quantizes the bank at construction and drops it from
    its params. Profiles 0 and 1 graduate with aggregated records (the bf16
    engine's admission aggregates, quantized on write), so the first wave
    admits through quant_mixed. On the first QUANT_LAYERS (6) of the 24
    layers: composed, #6 runs 6 times per decode step and per prefill
    batch; ``decode_fused``: #8's int8/int4 route 6 times per decode step
    and #6 per prefill batch only. The bf16 kernels must not launch. Held
    to its kernel_impl="ref" run as the bf16 paths are."""
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.utils.tree import tree_map

    # the first QUANT_LAYERS layers' weights, bank, table rows and
    # aggregates (views)
    L = QUANT_LAYERS
    cfg = ctx["cfg"].with_xpeft(bank_quant=scheme).with_(decode_fused=fused,
                                                         num_layers=L)
    params = dict(ctx["params"], **{
        k: tree_map(lambda t: t[:L], ctx["params"][k])
        for k in ("blocks", "xpeft_bank")})
    xp = cfg.xpeft
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k, quant=scheme,
                         quant_group=xp.quant_group)
    for pid in range(4):
        entry = ctx["engine"].profile_cache.peek(pid)
        agg = (entry["a_hat"][:L], entry["b_hat"][:L]) if pid < 2 else None
        store.add_profile(pid, {k: v[pid, :L]
                                for k, v in ctx["table"].items()}, agg=agg)
    label = f"{scheme} {'decode_fused' if fused else 'composed'}"

    def check_launches(launches, st, waves):
        assert st["bank_quant"] == scheme
        assert waves[0]["path"] == "quant_mixed", waves[0]
        assert waves[0]["bank_bytes_per_request"] > 0
        aggregating = sum(w["path"] in ("quant_sparse", "quant_mixed")
                          for w in waves)
        assert launches["mask_aggregate_quant_batched"] == 2 * aggregating
        assert launches["mask_aggregate_batched"] == 0
        assert launches["fused_adapter_batched"] == 0
        steps, batches = st["device_steps"], st["prefill_batches"]
        if fused:
            assert launches["decode_block_fused"] == L * steps > 0
            assert launches["fused_adapter_quant_batched"] == L * batches
        else:
            assert launches["decode_block_fused"] == 0
            assert launches["fused_adapter_quant_batched"] == \
                L * (steps + batches) > 0

    def check_runs(eng, ref_eng):
        # store records copied, aggregated ones re-quantized from
        # bitwise-equal aggregates: the admitted records are equal
        equal = all(torch.equal(eng.profile_cache.peek(pid)[k],
                                ref_eng.profile_cache.peek(pid)[k])
                    for pid in range(4)
                    for k in eng.profile_cache.peek(pid))
        log(f"  kernel vs ref: admitted quantized records bitwise {equal}")
        assert equal and "xpeft_bank" not in eng.params

    eng, reqs, launches, stats = drive_path(
        torch, label, cfg, params, store,
        (("mask_aggregate_quant_batched", KAQ.mask_aggregate_quant_batched),
         ("fused_adapter_quant_batched", KFQ.fused_adapter_quant_batched),
         ("decode_block_fused", KD.decode_block_fused),
         ("mask_aggregate_batched", KA.mask_aggregate_batched),
         ("fused_adapter_batched", KF.fused_adapter_batched)),
        check_launches, check_runs, report_share=True)
    stats["resident_bank_bytes"] = sum(v.numel() * v.element_size()
                                       for v in eng.qbank.values())
    stats["layers"] = L
    log(f"  {L} of 24 layers; quantized bank resident "
        f"{stats['resident_bank_bytes'] / 1e6:.1f} MB")
    return launches, stats


# ----------------------------------------------------------------------------
# phase 6: heterogeneous bank (bottleneck / LoRA / IA3 / prefix)
# ----------------------------------------------------------------------------

# qwen1.5-0.5b's N=256 split in README's 40/40/10/10 proportions, P=8
HETERO_SPEC = (("bottleneck", 102), ("lora", 102), ("ia3", 26),
               ("prefix", 26))
HETERO_P = 8


def ia3_inputs(torch, gen, B, T, d, dtype, s_dtype, L=24, shared=False):
    """x [B, T, d] and one layer's s: a slice of the engine's [B, L, d]
    slot buffer (batch stride L*d), or a shared [d]."""
    x = torch.randn((B, T, d), generator=gen, device="cuda").to(dtype)
    if shared:
        s = 0.05 * torch.randn((d,), generator=gen, device="cuda")
        return x, s.to(s_dtype)
    buf = 0.05 * torch.randn((B, L, d), generator=gen, device="cuda")
    return x, buf.to(s_dtype)[:, L // 2]


def check_ia3(torch, KI, ref, x, s, label):
    got = KI.ia3_apply_batched(x, s)
    want = ref.ia3_apply_batched_ref(x, s)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    log(f"  check ia3 {label}: max_abs_err {err:.3e} (bitwise "
        f"{torch.equal(got, want)})")
    assert torch.equal(got, want), label
    return err


def phase_ia3(torch, KI, ref):
    """#7 at the hetero path's shapes (B=4, d=1024, bf16 x, s a layer
    slice of the [B, 24, 1024] slot buffer): bitwise against its plain
    version at decode (T=1) and prefill (T=16), with a shared s, fp32 x,
    an fp32 s, and s = 0 (y bitwise x); then timed, beside the one
    PyTorch call that computes the same function, ``torch.addcmul(x, x,
    s)`` (x + x·s in fp32, one rounding; x·s and x·(1+s) are exact in
    fp32 at bf16 inputs, so it is expected bitwise equal)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    B, d = 4, 1024
    bf16, f32 = torch.bfloat16, torch.float32
    for T in (1, 16):
        check_ia3(torch, KI, ref, *ia3_inputs(torch, gen, B, T, d, bf16,
                                              bf16), f"bf16 slice T={T}")
    check_ia3(torch, KI, ref, *ia3_inputs(torch, gen, B, 16, d, bf16, bf16,
                                          shared=True), "bf16 shared s")
    check_ia3(torch, KI, ref, *ia3_inputs(torch, gen, B, 16, d, f32, f32),
              "fp32 x, fp32 s")
    check_ia3(torch, KI, ref, *ia3_inputs(torch, gen, B, 1, d, bf16, f32),
              "bf16 x, fp32 s")
    check_ia3(torch, KI, ref, *ia3_inputs(torch, gen, B, 1, d, f32, bf16),
              "fp32 x, bf16 s")
    for dt in (bf16, f32):
        x, s = ia3_inputs(torch, gen, B, 16, d, dt, bf16)
        zero = KI.ia3_apply_batched(x, torch.zeros_like(s))
        torch.cuda.synchronize()
        log(f"  check ia3 s=0 {dt}: y bitwise x {torch.equal(zero, x)}")
        assert torch.equal(zero, x)
    results = []
    for T in (1, 16):
        sets = [ia3_inputs(torch, gen, B, T, d, bf16, bf16)
                for _ in range(64)]
        err = check_ia3(torch, KI, ref, *sets[0], f"bf16 timed T={T}")
        ms = device_ms(torch, rotating(KI.ia3_apply_batched, sets),
                       calls=len(sets))
        plain_ms = device_ms(torch, rotating(ref.ia3_apply_batched_ref,
                                             sets), calls=len(sets))
        host_ms = eager_ms(torch, rotating(KI.ia3_apply_batched, sets),
                           calls=len(sets))

        def library(x, s):
            return torch.addcmul(x, x, s.unsqueeze(-2))
        lib_ms = device_ms(torch, rotating(library, sets), calls=len(sets))
        x, s = sets[0]
        lib = library(x, s)
        want = ref.ia3_apply_batched_ref(x, s)
        lib_bitwise = torch.equal(lib, want)
        lib_err = (lib.float() - want.float()).abs().max().item()
        nbytes = 2 * x.numel() * x.element_size() + B * d * s.element_size()
        bound_ms, bound_by = bound(nbytes, 2 * x.numel(), "float32")
        log(f"ia3_apply_batched B={B} T={T} d={d} bf16: ms {ms:.5f} | "
            f"plain {plain_ms:.5f} | addcmul {lib_ms:.5f} (vs plain: "
            f"bitwise {lib_bitwise}, max_abs_err {lib_err:.3e}) | eager "
            f"call (host included) {host_ms:.5f} | bound {bound_ms:.6f} "
            f"({bound_by}: {nbytes / 1e3:.1f} KB)")
        results.append(dict(shape=f"T={T}", max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms,
                            library_bitwise=lib_bitwise, eager_ms=host_ms))
    return results


HETERO_SUBSETS = (("bottleneck",), ("lora",), ("ia3",),
                  ("bottleneck", "lora"), ("bottleneck", "ia3"),
                  ("lora", "ia3"), ("bottleneck", "lora", "ia3"))


def hetero_operands(torch, gen, B, T, d, b, dtype, shared):
    """x [B, T, d] and every stage's operands, as ``ops.hetero_adapter``
    gets them from the engine: one layer of [B, L, ...] slot buffers
    (batch strides; s in x's dtype, as the engine keeps ia3_s), or shared
    ones. Returns (x, {stage: operands})."""
    lead = () if shared else (B, 3)

    def rnd(shape, scale, dt=dtype, offset=0.0):
        t = (offset + torch.randn(lead + shape, generator=gen,
                                  device="cuda") * scale).to(dt)
        return t if shared else t[:, 1]
    x = torch.randn((B, T, d), generator=gen, device="cuda").to(dtype)
    f32 = torch.float32
    return x, {"bottleneck": (rnd((d, b), d ** -0.5), rnd((b, d), 0.05),
                              rnd((b,), 0.1, f32, 1.0), rnd((b,), 0.1, f32)),
               "lora": (rnd((d, b), d ** -0.5), rnd((b, d), 0.05)),
               "ia3": rnd((d,), 0.05)}


def hetero_sequence(KF, KI, x, bottleneck=None, lora=None, ia3=None):
    """The three separate CUDA launches the fused one replaces: #2, #2's
    LoRA route, #7, each stage present in order."""
    if bottleneck is not None:
        x = KF.fused_adapter_batched(x, *bottleneck)
    if lora is not None:
        x = KF.fused_adapter_batched(x, *lora, None, None,
                                     activation="identity", use_ln=False)
    if ia3 is not None:
        x = KI.ia3_apply_batched(x, ia3)
    return x


def check_hetero(torch, KH, KF, KI, ref, x, stages, label):
    """The fused launch bitwise equal to the CUDA sequence, and each stage
    of the sequence within the fused adapter's bounds of its plain version
    on the same input (IA3 bitwise). Returns the fused output's max
    |error| against the whole plain composition, reported only: a
    one-step difference after one stage is carried by the next, where the
    output may be far smaller than the value it was rounded at."""
    got = KH.hetero_adapter_batched(x, **stages)
    seq = hetero_sequence(KF, KI, x, **stages)
    want = ref.hetero_adapter_batched_ref(x, **stages)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    bitwise = torch.equal(got, seq)
    rtol, atol = (FA_BF16_RTOL, FA_BF16_ATOL) \
        if x.dtype == torch.bfloat16 else (FA_F32_RTOL, FA_F32_ATOL)
    y, stage_ok = x, True
    for name in ("bottleneck", "lora", "ia3"):
        if name not in stages:
            continue
        one = {name: stages[name]}
        k_out = hetero_sequence(KF, KI, y, **one)
        p_out = ref.hetero_adapter_batched_ref(y, **one)
        if name == "ia3":
            stage_ok &= torch.equal(k_out, p_out)
        else:
            stage_ok &= bool(((k_out.float() - p_out.float()).abs()
                              <= rtol * p_out.float().abs() + atol).all())
        y = k_out
    err = (got.float() - want.float()).abs().max().item()
    log(f"  check hetero {label}: bitwise the CUDA sequence {bitwise}; "
        f"stages within bounds {stage_ok}; max_abs_err vs the plain "
        f"composition {err:.3e}")
    assert bitwise and stage_ok, label
    return err


# widths no cluster of the hetero launch fits with a bottleneck and a
# LoRA stage (dbrx-132b's d at T > 1, llava-next-34b's at any T):
# ``ops.hetero_adapter`` runs the three kernels there
HETERO_WIDE = ((6144, 16), (7168, 1), (7168, 16))


def hetero_route_rows(torch, KH, KF, KI, ref, gen, B=4, b=64):
    """``ops.hetero_adapter`` at HETERO_WIDE in bf16 on layer slices, all
    three stages: the route is "separate", launches #2 twice and #7 once
    (the hetero launch never), equals the CUDA sequence bitwise, and each
    of its stages holds to its plain version (``check_hetero``'s
    bounds)."""
    from repro_torch.kernels import ops
    rows = []
    for d, T in HETERO_WIDE:
        x, st = hetero_operands(torch, gen, B, T, d, b, torch.bfloat16,
                                False)
        masks_l = dict(zip(ops.HETERO_STAGES["bottleneck"], st["bottleneck"]),
                       lora_a=st["lora"][0], lora_b=st["lora"][1],
                       ia3_s=st["ia3"])
        assert ops.hetero_route(x, st) == "separate", (d, T)
        fns = (KF.fused_adapter_batched, KI.ia3_apply_batched,
               KH.hetero_adapter_batched)
        for fn in fns:
            fn.launches = 0
        got = ops.hetero_adapter(x, masks_l, activation="gelu", impl="auto")
        launches = [fn.launches for fn in fns]
        assert launches == [2, 1, 0], launches
        seq = hetero_sequence(KF, KI, x, **st)
        want = ref.hetero_adapter_batched_ref(x, **st)
        torch.cuda.synchronize()
        assert torch.equal(got, seq) and torch.isfinite(got.float()).all()
        y = x
        for name in ("bottleneck", "lora", "ia3"):
            k_out = hetero_sequence(KF, KI, y, **{name: st[name]})
            p_out = ref.hetero_adapter_batched_ref(y, **{name: st[name]})
            if name == "ia3":
                assert torch.equal(k_out, p_out), (d, T)
            else:
                assert ((k_out.float() - p_out.float()).abs() <= FA_BF16_RTOL
                        * p_out.float().abs() + FA_BF16_ATOL).all(), (d, T)
            y = k_out
        err = (got.float() - want.float()).abs().max().item()
        log(f"  check hetero route d={d} T={T} bf16 slices: separate "
            f"(#2 x{launches[0]}, #7 x{launches[1]}, hetero launch "
            f"x{launches[2]}), bitwise the CUDA sequence, stages within "
            f"bounds; max_abs_err vs the plain composition {err:.3e}")
        rows.append(dict(shape=f"route separate d={d} T={T}",
                         max_abs_err=err, launches_fa=launches[0],
                         launches_ia3=launches[1]))
    for fn in fns:
        fn.launches = 0
    return rows


def phase_hetero_adapter(torch, KH, KF, KI, ref):
    """The hetero-adapter launch (#7's redesign) at the hetero path's
    shapes, B=4, d=1024, b=r=64: every subset of stages, T=1, 16 and 128
    (and T=17, a ragged tile, for all three), bf16 and fp32, layer slices
    and shared operands; bitwise the CUDA sequence #2 -> #2 (LoRA) -> #7
    (the planner picks each stage's own cluster size at these shapes);
    zero B̂s with s = 0 give x bitwise. Then timed, all three stages on
    layer slices in bf16, as cold CUDA-graph replays beside the sequence,
    the plain composition and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    B, d, b = 4, 1024, 64
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        for T in (1, 16, 128):
            for shared in (False, True):
                x, ops_ = hetero_operands(torch, gen, B, T, d, b, dtype,
                                          shared)
                for subset in HETERO_SUBSETS:
                    nbs = [b for s_ in subset if s_ != "ia3"]
                    assert KH.plan(d, nbs, T, x.element_size(),
                                   ops_["ia3"].element_size()) \
                        == KF.plan(d, b, T, x.element_size()), subset
                    check_hetero(torch, KH, KF, KI, ref, x,
                                 {k: ops_[k] for k in subset},
                                 f"{'+'.join(subset)} {dtype} T={T} "
                                 f"{'shared' if shared else 'slices'}")
    x, ops_ = hetero_operands(torch, gen, B, 17, d, b, bf16, False)
    check_hetero(torch, KH, KF, KI, ref, x, ops_, "all bf16 T=17 slices")
    for dtype in (bf16, f32):
        x, ops_ = hetero_operands(torch, gen, B, 16, d, b, dtype, False)
        zero = dict(ops_, bottleneck=ops_["bottleneck"][:1]
                    + (torch.zeros_like(ops_["bottleneck"][1]),)
                    + ops_["bottleneck"][2:],
                    lora=(ops_["lora"][0], torch.zeros_like(ops_["lora"][1])),
                    ia3=torch.zeros_like(ops_["ia3"]))
        y = KH.hetero_adapter_batched(x, **zero)
        torch.cuda.synchronize()
        log(f"  check hetero zero B_hats, s = 0, {dtype}: y bitwise x "
            f"{torch.equal(y, x)}")
        assert torch.equal(y, x)
    route = hetero_route_rows(torch, KH, KF, KI, ref, gen)

    results = []
    for T in (1, 16, 128):
        # 64 input sets (2.1-3.1 MB each) rotate past the 50 MB L2, as
        # the decode path finds each layer's adapters cold
        sets = [hetero_operands(torch, gen, B, T, d, b, bf16, False)
                for _ in range(64)]
        x0, ops0 = sets[0]
        err = check_hetero(torch, KH, KF, KI, ref, x0, ops0,
                           f"all bf16 timed T={T}")
        sets = [(x, o["bottleneck"], o["lora"], o["ia3"]) for x, o in sets]

        def fused(x, bn, lo, s):
            return KH.hetero_adapter_batched(x, bottleneck=bn, lora=lo,
                                             ia3=s)

        def sequence(x, bn, lo, s):
            return hetero_sequence(KF, KI, x, bn, lo, s)

        def plain(x, bn, lo, s):
            return ref.hetero_adapter_batched_ref(x, bottleneck=bn, lora=lo,
                                                  ia3=s)
        ms = device_ms(torch, rotating(fused, sets), calls=len(sets))
        seq_ms = device_ms(torch, rotating(sequence, sets), calls=len(sets))
        plain_ms = device_ms(torch, rotating(plain, sets), calls=len(sets))
        host_ms = eager_ms(torch, rotating(fused, sets), calls=len(sets))
        x, bn, lo, s = sets[0]
        nbytes = 2 * x.numel() * x.element_size() \
            + sum(t.numel() * t.element_size() for t in (*bn, *lo, s))
        flops = 2 * 4 * B * T * d * b + 2 * B * T * d
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        before = BEFORE_MS.get(f"hetero sequence T={T}", "not timed")
        log(f"hetero_adapter_batched B={B} T={T} d={d} b=r={b} bf16, all "
            f"three stages: ms {ms:.5f} (cold) | the sequence #2 -> #2 -> "
            f"#7 {seq_ms:.5f} (cold; before, the sum of the kernels' rows: "
            f"{before}) | plain {plain_ms:.5f} | eager call (host "
            f"included) {host_ms:.5f} | bound {bound_ms:.6f} ({bound_by}: "
            f"{nbytes / 1e6:.3f} MB)")
        results.append(dict(shape=f"T={T}", max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None,
                            sequence_ms=seq_ms, eager_ms=host_ms))
        del sets
    return results + route


def agg_zero_terms(torch, KA, ref, bank, idx, w, label):
    """#1 bitwise against its plain version where dropping the zero-weight
    terms matters: on a copy of ``bank``, row 0 keeps its weights with
    every zero made -0.0, row 1 holds two terms of weight 0.5 whose bank
    rows cancel exactly (the second the first's negation) and zeros
    elsewhere, row 2 is padding (idx 0, w 0); rows 1 and 2 must come out
    +0."""
    bank = bank.clone()
    idx, w = idx.clone(), w.clone()
    w[0] = torch.where(w[0] == 0, torch.full_like(w[0], -0.0), w[0])
    r0, r1 = int(idx[1, 0]), int(idx[1, 1])
    if r0 == r1:
        r1 = (r0 + 1) % bank.shape[0]
        idx[1, 1] = r1
    bank[r1] = -bank[r0]
    w[1] = 0.0
    w[1, :2] = 0.5
    idx[2], w[2] = 0, 0.0
    got = KA.mask_aggregate_batched(bank, idx, w)
    want = ref.mask_aggregate_batched_ref(bank, idx, w)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    zeros = not got[1:3].abs().max().item() \
        and not torch.signbit(got[1:3]).any().item()
    log(f"  check {label} with -0.0 weights, cancelling terms and a pad "
        f"row: bitwise {same}; rows of +0 {zeros}")
    assert same and zeros, label


def phase_hetero_kernels(torch, KA, KF, ref):
    """#2's LoRA route (no LN, identity) on layer slices of [B, L, d, b]
    slot buffers with no LN affines, as ``ops.lora_adapter`` calls it, at
    T=1 and T=16; #1 at the typed leaves' admission shapes:
    IA3 [24*26, 1024, 1] and prefix [24*26, 8, 1024] rows, P = 4 profiles
    x 24 layers, k = 50 unified-space selections bucketed into the
    26-row segment (out-of-segment weights zero, as
    ``core.xpeft._segment_bucket`` leaves them). Bitwise, and timed as
    #1's other shapes."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, d, b = 4, 1024, 64
    bf16 = torch.bfloat16
    stack = [fa_inputs(torch, gen, B, 1, d, b, bf16)[1:3] for _ in range(3)]
    a3, b3 = (torch.stack(t, 1) for t in zip(*stack))
    lora = {}
    for T in (1, 16):
        x = fa_inputs(torch, gen, B, T, d, b, bf16)[0]
        lora[T] = check_fa(
            torch, KF, ref, (x, a3[:, 1], b3[:, 1], None, None),
            dict(activation="identity", use_ln=False), FA_BF16_RTOL,
            FA_BF16_ATOL, f"LoRA route, bf16 layer slice T={T}")

    L, C, P, k = 24, 26, 96, 50
    results = []
    # IA3 banks are 1.3 MB and prefix banks 10.2 MB: the timed calls
    # rotate over enough banks (83 and 82 MB) that each finds its rows cold
    for label, (p, q), n_banks in (("ia3 rows", (d, 1), 64),
                                   ("prefix rows", (HETERO_P, d), 8)):
        banks = [(torch.randn((L * C, p, q), generator=gen, device="cuda")
                  * 0.02).to(bf16) for _ in range(n_banks)]
        bank = banks[0]
        local = torch.randint(0, C, (P, k), generator=gen, device="cuda")
        layer = torch.arange(P, device="cuda") % L
        idx = (local + (layer * C)[:, None]).to(torch.int32).contiguous()
        in_seg = torch.rand((P, k), generator=gen, device="cuda") < 0.1
        w = in_seg.float() / k
        got = KA.mask_aggregate_batched(bank, idx, w)
        want = ref.mask_aggregate_batched_ref(bank, idx, w)
        again = KA.mask_aggregate_batched(bank, idx, w)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (P, p, q)
        err = (got - want).abs().max().item()
        log(f"mask_aggregate_batched[{label}] P={P} k={k} bank "
            f"{tuple(bank.shape)} bf16: max_abs_err {err:.3e} (bitwise "
            f"{torch.equal(got, want)}; two calls bitwise "
            f"{torch.equal(got, again)})")
        assert torch.equal(got, want) and torch.equal(got, again), label
        sets = [(bk, idx, w) for bk in banks]
        ms = device_ms(torch, rotating(KA.mask_aggregate_batched, sets),
                       calls=64)
        host_ms = eager_ms(torch, lambda: KA.mask_aggregate_batched(
            bank, idx, w), calls=3)
        plain_ms = eager_ms(torch, lambda: ref.mask_aggregate_batched_ref(
            bank, idx, w), calls=1)
        # the rows this data reads: distinct selected rows of nonzero weight
        uniq = int(torch.unique(idx[w > 0]).numel())
        nbytes = uniq * p * q * bank.element_size() + idx.numel() * 8 \
            + P * p * q * 4
        bound_ms, bound_by = bound(nbytes, 2 * P * k * p * q, "float32")
        w16 = w.to(bf16)
        flats = [(idx, bk.view(bk.shape[0], -1), w16) for bk in banks]

        def library(i, fl, ww):
            return torch.nn.functional.embedding_bag(
                i, fl, per_sample_weights=ww, mode="sum")
        lib_ms = device_ms(torch, rotating(library, flats), calls=64)
        lib_eager = eager_ms(torch, lambda: library(*flats[0]), calls=3)
        log(f"  ms {ms:.5f} (cold graph replay) | eager {host_ms:.4f} "
            f"(before: eager {BEFORE_MS[label]}) | plain {plain_ms:.4f} | "
            f"embedding_bag {lib_ms:.5f} (eager {lib_eager:.4f}) | bound "
            f"{bound_ms:.5f} ({bound_by}: {nbytes / 1e6:.2f} MB, {uniq} "
            f"rows of nonzero weight)")
        agg_zero_terms(torch, KA, ref, bank, idx, w, label)
        results.append(dict(shape=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=lib_ms,
                            eager_ms=host_ms, library_eager_ms=lib_eager))
        del banks, sets, flats, bank
        torch.cuda.empty_cache()
    return lora, results


def hetero_setup(torch, cfg):
    """qwen1.5-0.5b's weights and typed bank from seed 0 through
    ``init_lm``, and 4 hard-mask profiles crafted as
    ``benchmarks/hetero_smoke.py`` crafts them: 1 with every prefix-segment
    logit at -30 (no prefix slot: its prompt prefills at cache slot 0),
    2 with them at -30 on odd layers only (the per-layer gate), 0 and 3
    as drawn."""
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.models import init_lm

    xp = cfg.xpeft
    t0 = time.perf_counter()
    params = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    bank_bytes = sum(v.numel() * v.element_size()
                     for v in params["xpeft_bank"].values())
    log(f"serve hetero: bank_spec {xp.bank_spec}, P={xp.prefix_tokens}; "
        f"resident typed bank {bank_bytes / 1e6:.1f} MB ("
        + ", ".join(f"{k} {tuple(v.shape)}"
                    for k, v in params["xpeft_bank"].items())
        + f"), init {time.perf_counter() - t0:.2f}s")
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k, bank_spec=xp.bank_spec)
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=4), seed=0)
    off, cnt = next((o, c) for t, o, c in xp.segments() if t == "prefix")
    for pid in range(4):
        row = {k: v[pid].clone() for k, v in table.items()}
        for m in ("mA", "mB"):
            if pid == 1:
                row[m][:, off:off + cnt] = -30.0
            elif pid == 2:
                row[m][1::2, off:off + cnt] = -30.0
        store.add_profile(pid, row)
    return params, store, bank_bytes


def phase_serve_hetero(torch, KA, KF, KI, KH, KAQ, KFQ, KD, ctx):
    """qwen1.5-0.5b at full width with the typed bank HETERO_SPEC, P=8,
    composed: #1 launches 10 times per aggregating wave (bottleneck and
    LoRA A/B, IA3 and prefix K/V from both masks), the hetero-adapter
    launch (bottleneck, LoRA and IA3) 24 times per decode step and prefill
    batch; #2, #7, #5, #6 and #8 not at all. Held to its kernel_impl="ref"
    run as the other paths; one prefill batch must hold prefix-on
    (cache_pos 8) and prefix-off (cache_pos 0) requests. Then the same
    requests with decode_fused=True: hetero entries stay composed, so #8
    must not launch, the hetero-adapter launch runs as composed and the
    tokens equal the composed run's. Last, #7 on the entries it keeps,
    IA3 alone: an admitted profile's ia3_s through the model's forward,
    24 launches, bitwise its kernel_impl="ref" forward. Returns the
    composed run's launches and stats, and #7's launches in that drive."""
    from repro_torch.serve import Request

    cfg = ctx["cfg"].with_xpeft(bank_spec=HETERO_SPEC,
                                prefix_tokens=HETERO_P)
    L = cfg.num_layers
    params, store, bank_bytes = hetero_setup(torch, cfg)
    counters = (("mask_aggregate_batched", KA.mask_aggregate_batched),
                ("fused_adapter_batched", KF.fused_adapter_batched),
                ("ia3_apply_batched", KI.ia3_apply_batched),
                ("hetero_adapter_batched", KH.hetero_adapter_batched),
                ("mask_aggregate_quant_batched",
                 KAQ.mask_aggregate_quant_batched),
                ("fused_adapter_quant_batched",
                 KFQ.fused_adapter_quant_batched),
                ("decode_block_fused", KD.decode_block_fused))
    batches_cpos = []
    per_shape = {}

    def check_launches(launches, st, waves):
        steps, batches = st["device_steps"], st["prefill_batches"]
        aggregating = sum(w["path"] == "sparse" for w in waves)
        # each aggregating wave: #1 twice for the IA3 rows (one per mask),
        # four times for the prefix K/V rows, four for the [d, b] leaves;
        # #2's LoRA route never (the hetero-adapter launch takes it)
        per_shape.update({"ia3 rows": 2 * aggregating,
                          "prefix rows": 4 * aggregating,
                          "lora": launches["fused_adapter_batched"]})
        assert aggregating > 0 and waves[0]["bank_bytes_per_request"] > 0
        assert launches["mask_aggregate_batched"] == 10 * aggregating
        assert launches["hetero_adapter_batched"] == L * (steps
                                                          + batches) > 0
        for name in ("fused_adapter_batched", "ia3_apply_batched",
                     "mask_aggregate_quant_batched",
                     "fused_adapter_quant_batched", "decode_block_fused"):
            assert launches[name] == 0, launches

    def check_runs(eng, ref_eng):
        # every typed aggregate goes through #1, bitwise its plain version
        equal = all(torch.equal(eng.profile_cache.peek(pid)[k],
                                ref_eng.profile_cache.peek(pid)[k])
                    for pid in range(4)
                    for k in eng.profile_cache.peek(pid))
        log(f"  kernel vs ref: admitted typed entries bitwise {equal}")
        assert equal

    from repro_torch.serve import ServeEngine
    prefill = ServeEngine.prefill_logits

    def spy(self, tokens, masks, lengths, cache_pos=None, prefix_rows=None):
        if cache_pos is not None:
            batches_cpos.append(sorted(set(cache_pos.tolist())))
        return prefill(self, tokens, masks, lengths, cache_pos, prefix_rows)
    ServeEngine.prefill_logits = spy
    try:
        eng, reqs, launches, stats = drive_path(
            torch, "hetero composed", cfg, params, store, counters,
            check_launches, check_runs)
    finally:
        ServeEngine.prefill_logits = prefill
    plen = {r.uid: r.prefix_len for r in reqs}
    log(f"  prefix rows per request {plen}; cache_pos sets of the prefill "
        f"batches {batches_cpos[:8]}")
    assert [plen[u] for u in (1, 5)] == [0, 0]
    # profile 2: gated off on every odd layer, on where an even layer
    # selected a prefix slot
    skip = eng.profile_cache.peek(2)["prefix_skip"]
    assert (skip[1::2] == HETERO_P).all() and (skip[0::2] == 0).any()
    assert any(c == [0, HETERO_P] for c in batches_cpos), batches_cpos
    stats["resident_bank_bytes"] = bank_bytes
    stats["prefix_len"] = plen
    stats["launches_by_shape"] = per_shape

    fused_cfg = cfg.with_(decode_fused=True)
    f_reqs = make_requests(Request, cfg.vocab_size)
    for _, fn in counters:
        fn.launches = 0
    f_eng, _, f_dt, _ = serve_once(torch, fused_cfg, params, store, f_reqs)
    st = f_eng.serve_stats()
    fused_n = {name: fn.launches for name, fn in counters}
    stats["decode_fused_tokens_equal"] = tokens_equal(f_reqs, reqs)
    log(f"serve hetero decode_fused=True: launches {fused_n}; tokens equal "
        f"to the composed run {stats['decode_fused_tokens_equal']:.3f}")
    assert fused_n["hetero_adapter_batched"] == L * (
        st["device_steps"] + st["prefill_batches"]) > 0
    assert not any(n for name, n in fused_n.items()
                   if name not in ("hetero_adapter_batched",
                                   "mask_aggregate_batched")), fused_n
    assert stats["decode_fused_tokens_equal"] == 1.0
    stats["decode_fused_launches"] = fused_n

    from repro_torch.models import forward
    ia3_s = eng.profile_cache.peek(0)["ia3_s"]
    masks = {"ia3_s": ia3_s.unsqueeze(0).repeat(4, *(1,) * ia3_s.ndim)}
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(11))
    want, _, _ = forward(params, tokens, cfg.with_xpeft(kernel_impl="ref"),
                         profile_masks=masks)
    for _, fn in counters:
        fn.launches = 0
    got, _, _ = forward(params, tokens, cfg, profile_masks=masks)
    torch.cuda.synchronize()
    ia3_n = {name: fn.launches for name, fn in counters}
    log(f"IA3-only entry through forward (x [4, 8, {cfg.d_model}]): "
        f"launches {ia3_n}; hidden states bitwise the ref forward "
        f"{torch.equal(got, want)}")
    assert ia3_n["ia3_apply_batched"] == L
    assert not any(n for name, n in ia3_n.items()
                   if name != "ia3_apply_batched"), ia3_n
    assert torch.equal(got, want)
    return launches, stats, ia3_n["ia3_apply_batched"]


# ----------------------------------------------------------------------------
# phase 7: training -> pack -> save/load -> serve the trained profiles
# ----------------------------------------------------------------------------

TRAIN_ARGV = ["--arch", "qwen1.5-0.5b", "--mode", "xpeft", "--steps", "10",
              "--batch", "8", "--seq", "64", "--profiles", "8", "--seed",
              "0", "--device", "cuda"]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@contextlib.contextmanager
def float64_everywhere(torch):
    """The port's float32 arithmetic run in float64: inside,
    ``torch.float32``, ``Tensor.float`` and the config dtype "float32"
    all give float64, so the model's float32 islands (the GLA, norms,
    softmax, the decay LoRA) run in float64 too. For a float64 twin of a
    float32 step whose state is cast to float64; restored on exit."""
    from repro_torch.models import model as MDL
    f32, to_float = torch.float32, torch.Tensor.float
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    MDL._DTYPES["float32"] = torch.float64
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float = f32, to_float
        MDL._DTYPES["float32"] = f32


def train_step_grads(torch, cfg, state, batch, noise, dev):
    """One xpeft step's (mask weights, gradients, loss, aux, seconds) on
    ``dev``: ``state`` and ``noise`` moved there."""
    from repro_torch.core import xpeft as XP
    from repro_torch.train import steps as ST

    st = _tree_to(state, dev)
    tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    nz = tuple(n.to(dev) for n in noise)
    prof = XP.gather_profiles(st["trainable"]["table"], tb["profile_ids"])
    w = XP.profile_mask_weights(prof, cfg.xpeft, noise=nz)
    t = time.perf_counter()
    grads, metrics = ST.grads_for_batch(st["frozen"], st["trainable"], tb,
                                        cfg, "xpeft", nz)
    if dev == "cuda":
        torch.cuda.synchronize()
    return dict(w=[x.detach().cpu() for x in w],
                grads=_tree_to(grads, "cpu"), loss=float(metrics["loss"]),
                aux=float(metrics["aux_loss"]), s=time.perf_counter() - t)


def rel_l2(a, b):
    """Relative L2 distance of a from b (absolute where b is 0)."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item() if b.norm() > 0 \
        else (a - b).norm().item()


def phase_train_step_vs_cpu(torch, cfg=None, prepare=None, check_w=None,
                            label="train (a)",
                            grad_rel_l2=TRAIN_GRAD_REL_L2, float64=False):
    """(a) One xpeft train step's forward and gradient on the card against
    the same step on the CPU: qwen1.5-0.5b at full width (the 151936-wide
    LM head included) cut to 2 layers, float32 with TF32 off, the same
    weights, batch and Gumbel draws. The k-hot selection must be bitwise
    equal, the loss within TRAIN_LOSS_RTOL and each trainable gradient
    leaf within TRAIN_GRAD_REL_L2 (relative L2; ``grad_rel_l2`` for a
    config whose own float32 gradient error is larger). ``cfg``: that
    config (another bank, e.g.); ``prepare(state, batch)`` edits the state
    before the step; ``check_w(w)`` checks the card's mask weights.
    ``float64``: the same step also in float64 on both devices, the card's
    loss and each gradient leaf within TRAIN_F64_REL of the CPU's, and
    each float32 run's distance from the card's float64 gradients (its
    float32 floor) reported."""
    from repro_torch.configs import get_config
    from repro_torch.core import masks as M
    from repro_torch.data import MarkovLM
    from repro_torch.train import steps as ST
    from repro_torch.utils.tree import tree_map

    cfg = cfg or get_config("qwen1.5-0.5b").with_(
        num_layers=2, dtype="float32").with_xpeft(max_profiles=8)
    xp = cfg.xpeft
    state = ST.init_train_state(cfg, "xpeft", seed=0, device="cuda")
    batch = MarkovLM(cfg.vocab_size, 8, seed=0).sample(0, 8, 64)
    if prepare is not None:
        prepare(state, batch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (8, cfg.num_layers, xp.num_adapters)
    noise = tuple(M.gumbel(shape, generator=gen, device="cuda")
                  for _ in range(2))
    gpu, cpu = (train_step_grads(torch, cfg, state, batch, noise, dev)
                for dev in ("cuda", "cpu"))
    if check_w is not None:
        check_w(gpu["w"])
    khot_equal = all(torch.equal(a > 0.5 / xp.k, b > 0.5 / xp.k)
                     for a, b in zip(gpu["w"], cpu["w"]))
    st_err = max((a - b).abs().max().item()
                 for a, b in zip(gpu["w"], cpu["w"]))
    loss_err = abs(gpu["loss"] - cpu["loss"])
    # the load-balance aux (0 for dense blocks) under the loss's bound
    aux_err = abs(gpu["aux"] - cpu["aux"])
    rel = {k: rel_l2(a, cpu["grads"]["table"][k])
           for k, a in gpu["grads"]["table"].items()}
    log(f"{label}: one xpeft step, {cfg.name} L={cfg.num_layers} "
        f"d={cfg.d_model} V={cfg.vocab_size} float32, B=8 T=64: card "
        f"{gpu['s']:.3f}s, CPU "
        f"{cpu['s']:.3f}s; k-hot selection bitwise equal {khot_equal}, "
        f"straight-through weights max|d| {st_err:.3e}; loss card "
        f"{gpu['loss']:.6f} CPU {cpu['loss']:.6f} |d| {loss_err:.3e} (tol "
        f"{TRAIN_LOSS_RTOL * abs(cpu['loss']):.3e}); grad relative L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (tol {grad_rel_l2}); aux card {gpu['aux']:.6f} CPU "
        f"{cpu['aux']:.6f} |d| {aux_err:.3e}")
    assert khot_equal
    assert loss_err <= TRAIN_LOSS_RTOL * abs(cpu["loss"]), loss_err
    assert aux_err <= TRAIN_LOSS_RTOL * abs(cpu["aux"]), aux_err
    assert all(v <= grad_rel_l2 for v in rel.values()), rel
    assert all(gpu["grads"]["table"][k].abs().max() > 0 for k in rel)
    out = dict(khot_bitwise=khot_equal, st_weights_max_abs_err=st_err,
               loss_card=gpu["loss"], loss_cpu=cpu["loss"],
               loss_abs_err=loss_err, aux_card=gpu["aux"],
               aux_cpu=cpu["aux"], aux_abs_err=aux_err, grad_rel_l2=rel)
    if float64:
        with float64_everywhere(torch):
            st64 = tree_map(lambda t: t.double() if t.is_floating_point()
                            else t, state)
            gpu64, cpu64 = (train_step_grads(
                torch, cfg, st64, batch, tuple(n.double() for n in noise),
                dev) for dev in ("cuda", "cpu"))
            del st64
        g64, c64 = gpu64["grads"]["table"], cpu64["grads"]["table"]
        assert all(v.dtype == torch.float64 for v in g64.values())
        rel64 = {k: rel_l2(g64[k], c64[k]) for k in g64}
        loss64 = abs(gpu64["loss"] - cpu64["loss"]) / abs(cpu64["loss"])
        floor = {k: dict(card=rel_l2(gpu["grads"]["table"][k], g64[k]),
                         cpu=rel_l2(cpu["grads"]["table"][k], g64[k]))
                 for k in g64}
        log(f"{label}: the same step in float64: card {gpu64['s']:.3f}s, "
            f"CPU {cpu64['s']:.3f}s; loss {gpu64['loss']:.12f} relative "
            f"|d| {loss64:.3e}; grad relative L2 card vs CPU "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel64.items())
            + f" (tol {TRAIN_F64_REL}); float32 runs from float64 (their "
            "floor): " + ", ".join(f"{k} card {v['card']:.3e} CPU "
                                   f"{v['cpu']:.3e}"
                                   for k, v in floor.items()))
        assert loss64 <= TRAIN_F64_REL, loss64
        assert all(v <= TRAIN_F64_REL for v in rel64.values()), rel64
        gc.collect()
        torch.cuda.empty_cache()
        out.update(float64_loss_rel_err=loss64, float64_grad_rel_l2=rel64,
                   float32_floor=floor)
    return out


def phase_train_full(torch, argv=TRAIN_ARGV):
    """(b) Ten xpeft steps of qwen1.5-0.5b (``argv``'s arch) at full width
    and depth in bf16 through ``launch/train.py``'s loop (its defaults: 8
    profiles, B=8, T=64, lr 1e-3): every loss and grad norm finite, the
    grad norm > 0, the mask logits moved; ms per step (CUDA events, median
    of steps 3-10), tokens/s, peak memory; then 3 more steps of the same
    loop's step function under torch.profiler for device ms and kernels
    per step."""
    import contextlib

    from repro_torch.launch import train as LT

    args = LT.parse_args(argv)
    ev, walls, first = [], [], {}

    @contextlib.contextmanager
    def observe(i, state):
        if i == 0:
            first["table"] = {k: v.clone() for k, v in
                              state["trainable"]["table"].items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        ev.append(a.elapsed_time(b))

    # the run's own peak: above what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = LT.run(args, observe=observe)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    hist = out["history"]
    losses = [float(m["loss"]) for m in hist]
    gnorms = [float(m["grad_norm"]) for m in hist]
    table = out["state"]["trainable"]["table"]
    moved = max((table[k] - first["table"][k]).abs().max().item()
                for k in ("mA", "mB"))
    ms = statistics.median(ev[2:])
    wall = statistics.median(walls[2:])
    tokens = args.batch * args.seq
    # the same loop's step, 3 more steps under the profiler
    state, step, src, gen = out["state"], out["step"], out["source"], \
        out["generator"]
    torch.cuda.synchronize()
    box = dict(state=state, i=args.steps)

    def steps():
        for _ in range(3):
            box["state"], _ = step(box["state"], src.sample(
                box["i"], args.batch, args.seq), gen)
            box["i"] += 1

    rows = trace_card(torch, steps, "train (b)")
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 3
    n_kernels = sum(e.count for e in rows) / 3
    cfg = out["cfg"]
    log(f"train (b): {args.steps} xpeft steps, {cfg.name} L={cfg.num_layers}"
        f" d={cfg.d_model} V={cfg.vocab_size} {cfg.dtype}, N="
        f"{cfg.xpeft.num_adapters} b={cfg.xpeft.bottleneck} k={cfg.xpeft.k}"
        f", {args.profiles} profiles, B={args.batch} T={args.seq}: "
        f"{total_s:.2f}s in all (init and first-call costs included)")
    log("  loss " + " ".join(f"{v:.4f}" for v in losses))
    log("  grad_norm " + " ".join(f"{v:.4e}" for v in gnorms))
    log("  ms/step (CUDA events) " + " ".join(f"{v:.2f}" for v in ev))
    log(f"  median of steps 3-{args.steps}: {ms:.3f} ms/step (host wall "
        f"{wall:.3f}), {tokens / ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held "
        f"before; mask logits moved by up to {moved:.3e}")
    log(f"  profiled steps: device {dev_ms:.3f} ms/step in "
        f"{n_kernels:.0f} kernels/step -> busy share {dev_ms / ms:.4f}; "
        "top kernels by device time:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / 3:.4f} ms/step "
            f"{e.count / 3:5.0f} launches/step  {e.key[:72]}")
    assert all(math.isfinite(v) for v in losses + gnorms)
    assert all(v > 0 for v in gnorms) and moved > 0
    stats = dict(steps=args.steps, batch=args.batch, seq=args.seq,
                 remat=out["cfg"].remat, losses=losses, grad_norms=gnorms,
                 ms_per_step=ms,
                 ms_per_step_all=ev, host_wall_ms_per_step=wall,
                 tokens_per_s=tokens / ms * 1e3, peak_memory_bytes=peak,
                 memory_held_before_bytes=held,
                 device_ms_per_step=dev_ms, kernels_per_step=n_kernels,
                 busy_share=dev_ms / ms, mask_logits_moved=moved)
    return out, stats


def stores_equal(back, store):
    """Two stores hold the same records byte for byte: the same profiles,
    fields, dtypes, bytes and checksums."""
    return back.profile_ids() == store.profile_ids() and all(
        list(back._rec[p]) == list(store._rec[p])
        and all(back._rec[p][k].dtype == v.dtype
                and back._rec[p][k].tobytes() == v.tobytes()
                for k, v in store._rec[p].items())
        and back._crc[p] == store._crc[p]
        for p in store.profile_ids())


def phase_pack_reload(torch, out):
    """(c) The trained table packed into a hard store (k=50) and a soft
    store; each saved, loaded back and held byte for byte to what was
    saved (keys, dtypes, bytes, checksums; nothing quarantined)."""
    import tempfile

    from repro_torch.core.profiles import ProfileStore

    cfg = out["cfg"]
    xp = cfg.xpeft
    table = out["state"]["trainable"]["table"]
    stores = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mtype in ("hard", "soft"):
            store = ProfileStore(cfg.num_layers, xp.num_adapters,
                                 xp.bottleneck, mtype, xp.k)
            for pid in range(table["mA"].shape[0]):
                store.add_profile(pid, {k: v[pid] for k, v in table.items()})
            path = os.path.join(tmp, f"{mtype}.npz")
            store.save(path)
            back = ProfileStore.load(path)
            equal = stores_equal(back, store)
            log(f"train (c): {mtype} store of {len(store.profile_ids())} "
                f"trained profiles, {store.record_nbytes(0)} B/record, "
                f"{os.path.getsize(path)} B on disk; reloaded byte-equal "
                f"{equal}, quarantined {back.quarantined_ids()}")
            assert equal and not back.quarantined_ids()
            stores[mtype] = back
    return stores


def phase_serve_trained(torch, KA, KF, KD, out, stores):
    """(d) The hard store served per step (precompute=False): composed,
    #1 and #2 never launch (each layer aggregates the k-hot weights
    against the bank in plain torch ops); held to the same store's
    precompute=True kernel_impl="ref" run. With decode_fused=True the
    megakernel must not launch either (per-step entries keep the composed
    path) and the tokens equal the composed per-step run's. (e) The soft
    store served with precompute=True: dense einsum admission (#1 0
    times), #2 24 times per decode step and prefill batch; held to its
    kernel_impl="ref" run."""
    cfg, params = out["cfg"], out["state"]["frozen"]
    L = cfg.num_layers
    counters = (("mask_aggregate_batched", KA.mask_aggregate_batched),
                ("fused_adapter_batched", KF.fused_adapter_batched),
                ("decode_block_fused", KD.decode_block_fused))

    def per_step_launches(launches, st, waves):
        assert {w["path"] for w in waves} == {"per_step"}, waves
        assert not any(launches.values()), launches

    _, reqs, launches, per_step = drive_path(
        torch, "per-step (precompute=False)", cfg, params, stores["hard"],
        counters, per_step_launches, report_share=True,
        eng_kw=dict(precompute=False), ref_kw=dict(precompute=True),
        own_prefill=True)
    per_step["launches"] = launches

    from repro_torch.serve import Request
    fcfg = cfg.with_(decode_fused=True)
    for _, fn in counters:
        fn.launches = 0
    freqs = make_requests(Request, cfg.vocab_size)
    _, _, _, fwaves = serve_once(torch, fcfg, params, stores["hard"], freqs,
                                 dict(precompute=False))
    flaunch = {name: fn.launches for name, fn in counters}
    feq = tokens_equal(freqs, reqs)
    log(f"serve per-step with decode_fused=True: launches {flaunch}; "
        f"tokens equal to the composed per-step run {feq:.3f}")
    assert not any(flaunch.values()), flaunch
    assert {w["path"] for w in fwaves} == {"per_step"}
    assert feq == 1.0
    per_step_fused = dict(launches=flaunch, tokens_equal_composed=feq)

    def soft_launches(launches, st, waves):
        assert waves[0]["path"] == "dense", waves[0]
        assert launches["mask_aggregate_batched"] == 0
        assert launches["decode_block_fused"] == 0
        assert launches["fused_adapter_batched"] == \
            L * (st["device_steps"] + st["prefill_batches"]) > 0

    _, _, launches, soft = drive_path(
        torch, "soft precompute", cfg, params, stores["soft"], counters,
        soft_launches, report_share=True)
    soft["launches"] = launches
    return per_step, per_step_fused, soft


# ----------------------------------------------------------------------------
# phase 8: the paper's encoder (bert-base-xpeft)
# ----------------------------------------------------------------------------

# as examples/train_multiprofile.py --preset paper: ProfileClassification
# over 8 profiles (seed 3), a 16-row table, lr 3e-2; at the paper's
# training shape (PAPER_SHAPE: B=64, T=128)
ENC_PROFILES, ENC_LR, ENC_STEPS = 8, 3e-2, 10


def kernel_counters():
    """Every hand-written kernel's wrapper by name (#1-#8 and the hetero
    launch); each counts its own launches."""
    from repro_torch.kernels import decode_fused, fused_adapter, \
        fused_adapter_batched, fused_adapter_quant, hetero_adapter, \
        ia3_apply, mask_aggregate, mask_aggregate_quant
    return {
        "mask_aggregate_batched": mask_aggregate.mask_aggregate_batched,
        "mask_aggregate": mask_aggregate.mask_aggregate,
        "fused_adapter_batched": fused_adapter_batched.fused_adapter_batched,
        "fused_adapter": fused_adapter.fused_adapter,
        "decode_block_fused": decode_fused.decode_block_fused,
        "mask_aggregate_quant_batched":
            mask_aggregate_quant.mask_aggregate_quant_batched,
        "fused_adapter_quant_batched":
            fused_adapter_quant.fused_adapter_quant_batched,
        "ia3_apply_batched": ia3_apply.ia3_apply_batched,
        "hetero_adapter_batched": hetero_adapter.hetero_adapter_batched}


def enc_setup(layers=None, dtype="bfloat16"):
    """(cfg, data, B, T): bert-base-xpeft (12 layers, d=768, 12 x 64 heads,
    d_ff 3072, vocab 30522, learned positions, LayerNorm, tanh-GELU MLP;
    N=100, b=48, k=50 hard masks, 15 labels) with a 16-row table, or cut to
    ``layers``; the 8-profile classification data; the paper's shape."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PAPER_SHAPE
    from repro_torch.data import ProfileClassification

    cfg = get_config("bert-base-xpeft").with_(dtype=dtype) \
        .with_xpeft(max_profiles=16)
    if layers:
        cfg = cfg.with_(num_layers=layers)
    data = ProfileClassification(cfg.vocab_size, cfg.num_labels,
                                 num_profiles=ENC_PROFILES, seed=3)
    return cfg, data, PAPER_SHAPE.global_batch, PAPER_SHAPE.seq_len


def named_leaves(tree, prefix=""):
    """[(path, leaf)] in the port's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def phase_encoder_step_vs_cpu(torch):
    """(a) One train step's loss, accuracy and gradients on the card
    against the same step on the CPU, for xpeft (hard masks, the same
    Gumbel draws), adapter and head_only: bert-base-xpeft at full width
    and vocabulary cut to 2 layers, float32 with TF32 off, B=64, T=128.
    The k-hot selection bitwise (xpeft), the loss within TRAIN_LOSS_RTOL,
    the accuracy equal, each trainable gradient leaf within
    TRAIN_GRAD_REL_L2 (relative L2)."""
    from repro_torch.core import masks as M
    from repro_torch.core import xpeft as XP
    from repro_torch.train import steps as ST

    cfg, data, B, T = enc_setup(layers=2, dtype="float32")
    xp = cfg.xpeft
    batch = data.sample(0, B, T)
    out = {}
    for mode in ("xpeft", "adapter", "head_only"):
        state = ST.init_train_state(cfg, mode, seed=0, device="cuda")
        noise = None
        if mode == "xpeft":
            gen = torch.Generator(device="cuda").manual_seed(1)
            shape = (B, cfg.num_layers, xp.num_adapters)
            noise = tuple(M.gumbel(shape, generator=gen, device="cuda")
                          for _ in range(2))
        runs = {}
        for dev in ("cuda", "cpu"):
            st = state if dev == "cuda" else _tree_to(state, "cpu")
            tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            nz = None if noise is None else tuple(n.to(dev) for n in noise)
            w = None
            if mode == "xpeft":
                prof = XP.gather_profiles(st["trainable"]["table"],
                                          tb["profile_ids"])
                w = [x.detach().cpu()
                     for x in XP.profile_mask_weights(prof, xp, noise=nz)]
            t = time.perf_counter()
            grads, metrics = ST.grads_for_batch(
                st["frozen"], st["trainable"], tb, cfg, mode, nz)
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = dict(w=w, grads=named_leaves(_tree_to(grads, "cpu")),
                             loss=float(metrics["loss"]),
                             acc=float(metrics["accuracy"]),
                             s=time.perf_counter() - t)
        gpu, cpu = runs["cuda"], runs["cpu"]
        khot = None if w is None else all(
            torch.equal(a > 0.5 / xp.k, b > 0.5 / xp.k)
            for a, b in zip(gpu["w"], cpu["w"]))
        loss_err = abs(gpu["loss"] - cpu["loss"])
        rel = {}
        for (name, a), (_, b) in zip(gpu["grads"], cpu["grads"]):
            rel[name] = ((a - b).norm() / b.norm()).item() if b.norm() > 0 \
                else (a - b).norm().item()
        log(f"encoder (a): one {mode} step, {cfg.name} L=2 d={cfg.d_model} "
            f"V={cfg.vocab_size} float32, B={B} T={T}: card {gpu['s']:.3f}s,"
            f" CPU {cpu['s']:.3f}s; k-hot selection bitwise equal {khot}; "
            f"loss card {gpu['loss']:.6f} CPU {cpu['loss']:.6f} |d| "
            f"{loss_err:.3e} (tol {TRAIN_LOSS_RTOL * abs(cpu['loss']):.3e});"
            f" accuracy card {gpu['acc']:.4f} CPU {cpu['acc']:.4f}; grad "
            "relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f" (tol {TRAIN_GRAD_REL_L2})")
        assert khot is None or khot
        assert loss_err <= TRAIN_LOSS_RTOL * abs(cpu["loss"]), loss_err
        assert gpu["acc"] == cpu["acc"], (gpu["acc"], cpu["acc"])
        assert all(v <= TRAIN_GRAD_REL_L2 for v in rel.values()), rel
        assert all(a.abs().max() > 0 for _, a in gpu["grads"])
        out[mode] = dict(khot_bitwise=khot, loss_card=gpu["loss"],
                         loss_cpu=cpu["loss"], loss_abs_err=loss_err,
                         accuracy_card=gpu["acc"], accuracy_cpu=cpu["acc"],
                         grad_rel_l2=rel)
        del state, runs
    return out


def phase_encoder_train(torch, counters):
    """(b) ENC_STEPS xpeft steps (hard masks) of bert-base-xpeft at full
    width and depth in bf16 through ``make_train_step`` at B=64, T=128, lr
    3e-2: every loss and grad norm finite, the mask logits moved; ms per
    step (CUDA events, median of steps 3-10), tokens/s, peak memory, then
    3 more steps under torch.profiler for device ms and kernels per step.
    Then 3 steps each of xpeft with soft masks, adapter and head_only,
    losses and grad norms finite. No hand-written kernel may launch: the
    launch counters stay at 0 from the first step to the last."""
    from repro_torch.train import steps as ST

    cfg, data, B, T = enc_setup()
    batches = [data.sample(i, B, T) for i in range(ENC_STEPS + 3)]
    for fn in counters.values():
        fn.launches = 0
    state = ST.init_train_state(cfg, "xpeft", seed=0, device="cuda")
    step = ST.make_train_step(cfg, "xpeft", lr=ENC_LR)
    gen = torch.Generator(device="cuda").manual_seed(1)
    table0 = {k: v.clone() for k, v in state["trainable"]["table"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ev, walls, hist = [], [], []
    for i in range(ENC_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batches[i], gen)
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        ev.append(a.elapsed_time(b))
        hist.append(m)
    peak = torch.cuda.max_memory_allocated() - held
    losses = [float(m["loss"]) for m in hist]
    gnorms = [float(m["grad_norm"]) for m in hist]
    accs = [float(m["accuracy"]) for m in hist]
    moved = max((state["trainable"]["table"][k] - table0[k]).abs().max()
                .item() for k in ("mA", "mB"))
    ms = statistics.median(ev[2:])
    wall = statistics.median(walls[2:])
    box = dict(state=state)

    def steps():
        for i in range(ENC_STEPS, ENC_STEPS + 3):
            box["state"], _ = step(box["state"], batches[i], gen)

    rows = trace_card(torch, steps, "encoder (b)")
    state = box["state"]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 3
    n_kernels = sum(e.count for e in rows) / 3
    tokens = B * T
    log(f"encoder (b): {ENC_STEPS} xpeft steps, {cfg.name} L="
        f"{cfg.num_layers} d={cfg.d_model} V={cfg.vocab_size} {cfg.dtype},"
        f" N={cfg.xpeft.num_adapters} b={cfg.xpeft.bottleneck} "
        f"k={cfg.xpeft.k}, {ENC_PROFILES} profiles, B={B} T={T}, lr "
        f"{ENC_LR}")
    log("  loss " + " ".join(f"{v:.4f}" for v in losses))
    log("  accuracy " + " ".join(f"{v:.4f}" for v in accs))
    log("  grad_norm " + " ".join(f"{v:.4e}" for v in gnorms))
    log("  ms/step (CUDA events) " + " ".join(f"{v:.2f}" for v in ev))
    log(f"  median of steps 3-{ENC_STEPS}: {ms:.3f} ms/step (host wall "
        f"{wall:.3f}), {tokens / ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held "
        f"before; mask logits moved by up to {moved:.3e}")
    log(f"  profiled steps: device {dev_ms:.3f} ms/step in "
        f"{n_kernels:.0f} kernels/step -> busy share {dev_ms / ms:.4f}; "
        "top kernels by device time:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / 3:.4f} ms/step "
            f"{e.count / 3:5.0f} launches/step  {e.key[:72]}")
    assert all(math.isfinite(v) for v in losses + gnorms)
    assert all(v > 0 for v in gnorms) and moved > 0
    others = {}
    for mode, mask in (("xpeft", "soft"), ("adapter", "hard"),
                       ("head_only", "hard")):
        mcfg = cfg.with_xpeft(mask_type=mask)
        st = ST.init_train_state(mcfg, mode, seed=0, device="cuda")
        stp = ST.make_train_step(mcfg, mode, lr=ENC_LR)
        ms_ = []
        for i in range(3):
            st, m = stp(st, batches[i], gen)
            ms_.append(m)
        row = {k: [float(m[k]) for m in ms_]
               for k in ("loss", "grad_norm", "accuracy")}
        label = f"{mode}" + (f" {mask}" if mode == "xpeft" else "")
        log(f"  3 steps {label}: loss " + " ".join(
            f"{v:.4f}" for v in row["loss"]) + "; grad_norm " + " ".join(
            f"{v:.4e}" for v in row["grad_norm"]))
        assert all(math.isfinite(v) for v in row["loss"] + row["grad_norm"])
        assert all(v > 0 for v in row["grad_norm"])
        others[label] = row
        del st
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"  hand-written kernel launches during training: {launches}")
    assert not any(launches.values()), launches
    stats = dict(steps=ENC_STEPS, batch=B, seq=T, lr=ENC_LR,
                 remat=cfg.remat, losses=losses,
                 accuracies=accs, grad_norms=gnorms, ms_per_step=ms,
                 ms_per_step_all=ev, host_wall_ms_per_step=wall,
                 tokens_per_s=tokens / ms * 1e3, peak_memory_bytes=peak,
                 memory_held_before_bytes=held, device_ms_per_step=dev_ms,
                 kernels_per_step=n_kernels, busy_share=dev_ms / ms,
                 mask_logits_moved=moved, other_modes=others,
                 kernel_launches=launches)
    return dict(cfg=cfg, data=data, state=state, B=B, T=T), stats


def phase_encoder_heldout(torch, enc):
    """(c) Held-out accuracy of the trained profiles through
    ``loss_for_batch(training=False)`` (k-hot masks) on 4 fresh batches
    of 32, as ``benchmarks/glue_sim.py``'s ``train_and_eval`` scores it.
    Reported, not asserted: random PLM weights and ten steps sit near
    chance (1/15)."""
    from repro_torch.train import steps as ST

    cfg, data, state, T = enc["cfg"], enc["data"], enc["state"], enc["T"]
    accs = []
    with torch.no_grad():
        for j in range(4):
            b = data.sample(10_000 + j, 32, T)
            batch = {k: torch.as_tensor(v).cuda() for k, v in b.items()}
            _, m = ST.loss_for_batch(state["frozen"], state["trainable"],
                                     batch, cfg, "xpeft", None,
                                     training=False)
            accs.append(float(m["accuracy"]))
    acc = statistics.mean(accs)
    log(f"encoder (c): held-out accuracy {acc:.4f} (batches "
        + ", ".join(f"{a:.4f}" for a in accs) + "; chance "
        f"{1 / cfg.num_labels:.4f})")
    return dict(heldout_accuracy=acc, heldout_batches=accs)


def phase_encoder_store(torch, enc):
    """(d) The trained table and heads packed into a hard store (k=50,
    heads fp16), saved to .npz and loaded back byte-equal; then the
    store-hydrated evaluation of examples/train_multiprofile.py on one
    batch of 64 rows over the 8 profiles: ``batch_mask_weights`` ->
    ``forward`` (the dense mask-weight route) -> ``store.head`` ->
    ``cls_logits``."""
    import tempfile

    from repro_torch.core.profiles import ProfileStore
    from repro_torch.models import model as MDL

    cfg, state, B, T = enc["cfg"], enc["state"], enc["B"], enc["T"]
    xp, tr = cfg.xpeft, state["trainable"]
    store = ProfileStore(cfg.num_layers, xp.num_adapters, xp.bottleneck,
                         "hard", xp.k)
    for pid in range(ENC_PROFILES):
        store.add_profile(pid, {
            **{k: v[pid] for k, v in tr["table"].items()},
            **{k: v[pid] for k, v in tr["heads"].items()}})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "encoder.npz")
        store.save(path)
        size = os.path.getsize(path)
        back = ProfileStore.load(path)
    equal = stores_equal(back, store)
    log(f"encoder (d): hard store of {len(store.profile_ids())} trained "
        f"profiles with heads, {store.record_nbytes(0)} B/record, {size} B "
        f"on disk; reloaded byte-equal {equal}, quarantined "
        f"{back.quarantined_ids()}")
    assert equal and not back.quarantined_ids()
    ev = enc["data"].sample(20_000, B, T)
    pids = [int(p) for p in ev["profile_ids"]]
    hw, hb = zip(*(back.head(p) for p in pids))
    heads = {"head_w": torch.stack(hw).cuda(),
             "head_b": torch.stack(hb).cuda()}
    wa, wb, ls, lb = (t.cuda() for t in back.batch_mask_weights(pids))
    tokens = torch.as_tensor(ev["tokens"]).cuda()
    labels = torch.as_tensor(ev["labels"]).cuda().long()
    with torch.no_grad():
        hidden = MDL.forward(state["frozen"], tokens, cfg, profile_masks={
            "w_a": wa, "w_b": wb, "ln_scale": ls, "ln_bias": lb})[0]
        logits = MDL.cls_logits(state["frozen"], hidden, cfg, heads)
    acc = (logits.argmax(-1) == labels).float().mean().item()
    log(f"  store-hydrated evaluation, dense mask weights: {B} rows over "
        f"{len(set(pids))} profiles, accuracy {acc:.4f}")
    assert torch.isfinite(logits).all()
    assert logits.shape == (B, cfg.num_labels)
    ctx = dict(store=back, pids=pids, heads=heads, tokens=tokens,
               labels=labels, dense_logits=logits)
    return ctx, dict(record_bytes=store.record_nbytes(0), file_bytes=size,
                     reload_byte_equal=equal, dense_accuracy=acc)


def phase_encoder_kernels(torch, counters, enc, ctx):
    """(e) The same store admitted through the kernels on the same batch:
    the 8 distinct profiles' k-sparse indices aggregated once with
    ``precompute_effective_adapters_sparse`` (#1: 2 launches, P = 8 x 12
    = 96 rows of 768 x 48, k=50), the aggregates gathered per row into
    the a_hat/b_hat/ln entry and run through ``forward`` (#2: 12 launches
    at B=64, T=128, d=768, b=48, bf16), then ``cls_logits`` with the
    store's heads. Held to the same route on kernel_impl="ref" on the
    card: max |d logit| <= E2E_STEPS bf16 steps at the largest |logit|,
    every predicted-label flip on a ref top-2 gap <= 2 x that max |d|.
    The gap to (d)'s dense-weight route is reported (the two routes round
    the aggregates differently)."""
    from repro_torch.core import xpeft as XP
    from repro_torch.models import model as MDL

    cfg, frozen = enc["cfg"], enc["state"]["frozen"]
    store, pids = ctx["store"], ctx["pids"]
    ia, wa, ib, wb = (t.cuda() for t in store.batch_sparse_indices(
        range(ENC_PROFILES)))
    ls, lb = (t.cuda() for t in store.ln_affines(pids))
    rows = torch.as_tensor(pids).cuda().long()

    def route(c):
        with torch.no_grad():
            a_hat, b_hat = XP.precompute_effective_adapters_sparse(
                frozen["xpeft_bank"], ia, wa, ib, wb, c.xpeft)
            entry = {"a_hat": a_hat[rows], "b_hat": b_hat[rows],
                     "ln_scale": ls, "ln_bias": lb}
            hidden = MDL.forward(frozen, ctx["tokens"], c,
                                 profile_masks=entry)[0]
            return MDL.cls_logits(frozen, hidden, c, ctx["heads"])

    for fn in counters.values():
        fn.launches = 0
    got = route(cfg)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    want = route(cfg.with_xpeft(kernel_impl="ref"))
    torch.cuda.synchronize()
    L = cfg.num_layers
    log(f"encoder (e): the store admitted through the kernels, launches "
        f"{launches}")
    assert launches["mask_aggregate_batched"] == 2, launches
    assert launches["fused_adapter_batched"] == L, launches
    assert sum(launches.values()) == 2 + L, launches
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = E2E_STEPS * bf16_step(scale)
    pred, pred_ref = got.argmax(-1), want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    flips = [(int(i), gap[i].item())
             for i in (pred != pred_ref).nonzero()[:, 0]]
    dense_err = (got - ctx["dense_logits"]).abs().max().item()
    labels = ctx["labels"]
    acc = (pred == labels).float().mean().item()
    acc_ref = (pred_ref == labels).float().mean().item()
    log(f"  kernels vs ref: max|d logit| {err:.4e}; max|logit| {scale:.4f} "
        f"(bf16 step {bf16_step(scale):.4e}, tol {tol:.4e}); predicted-"
        f"label flips {len(flips)} (row, ref top-2 gap) {flips}; accuracy "
        f"kernels {acc:.4f} ref {acc_ref:.4f}; max|d logit| to the dense-"
        f"weight route of (d) {dense_err:.4e} (reported)")
    assert err <= tol, (err, tol)
    assert all(g <= 2 * err for _, g in flips), flips
    return dict(launches=launches, max_abs_err=err, max_logit=scale,
                flips=flips, accuracy=acc, accuracy_ref=acc_ref,
                dense_route_max_abs_diff=dense_err)


def phase_encoder(torch):
    """Phase 8, (a)-(e): returns the ``{"encoder": ...}`` JSON line's
    dict."""
    counters = kernel_counters()
    step_vs_cpu = phase_encoder_step_vs_cpu(torch)
    torch.cuda.empty_cache()
    enc, train = phase_encoder_train(torch, counters)
    heldout = phase_encoder_heldout(torch, enc)
    ctx, store = phase_encoder_store(torch, enc)
    kernels = phase_encoder_kernels(torch, counters, enc, ctx)
    return dict(config=enc["cfg"].name, step_vs_cpu=step_vs_cpu,
                train=train, heldout=heldout, store=store, kernels=kernels)


# ----------------------------------------------------------------------------
# phase 9: continuous batching over paged KV and pooled mask entries,
# preempt/resume, self-speculative decoding
# ----------------------------------------------------------------------------

CB_ENGINE = dict(max_slots=4, max_seq=128, sync_every=8)
CB_PAGE = 16
CB_GAMMA = 3
CB_STARVED = dict(long_new=100, max_pages=10)  # two long requests need 14
# run (g): 2 mask entries for the 4 slots, promotion after 2 waits
CB_ENTRIES = dict(mask_pages=2, max_wait_waves=2)


def skewed_requests(Request, vocab, n=12, *, seed=0, long_every=3,
                    short_new=2, long_new=40):
    """``benchmarks/cb_smoke.py``'s workload (copied): per-uid seeded
    prompts of 3-12 tokens, profiles uid % 3, 1 in ``long_every``
    requests ``long_new`` new tokens, the rest ``short_new``."""
    import numpy as np
    reqs = []
    for i in range(n):
        r = np.random.default_rng(seed * 7919 + i)
        T = int(r.integers(3, 13))
        reqs.append(Request(
            uid=i, prompt=r.integers(0, vocab, T), profile_id=i % 3,
            max_new_tokens=long_new if i % long_every == 0 else short_new))
    return reqs


def cb_engine(cfg, params, store, continuous, **kw):
    """An engine of phase 9's shape: 4 slots, max_seq 128, sync_every 8
    (``kw`` may override them); continuous ones on pages of 16 rows."""
    from repro_torch.serve import ServeEngine
    if continuous:
        kw = dict(kw, continuous=True, page_size=CB_PAGE)
    return ServeEngine(cfg, params, store, **dict(CB_ENGINE, **kw))


def cb_recorder(eng, MDL):
    """Hooks on one engine that keep the logits behind every token a drain
    emits, by (uid, token index): each request's prefill logits at 0, each
    decode step's (each verify position's) at the index it produces; and
    each request's prefill batch shape. A step's hook neither syncs nor
    copies: it keeps a reference to the step's logits, the slots' requests
    and their host token counts (with spec, a device copy of ``buf_len``),
    and ``finish`` files them after the drain. ``finish`` also undoes the
    one global hook (``MDL.lm_logits``)."""
    logits, shapes, groups, captured, steps = {}, {}, [], [], []
    lm = MDL.lm_logits
    group_by_bucket = eng.scheduler.group_by_bucket
    prefill, decode = eng.prefill_logits, eng.slots.decode_fn

    def lm_logits(*args, **kwargs):
        out = lm(*args, **kwargs)
        captured.append(out)
        return out

    def spy_groups(wave):
        out = group_by_bucket(wave)
        groups.extend(out[pad] for pad in sorted(out))
        return out

    def spy_prefill(tokens, *args, **kwargs):
        lg, mini = prefill(tokens, *args, **kwargs)
        for j, r in enumerate(groups.pop(0)):
            logits[(r.uid, 0)] = lg[j].float().clone()
            shapes[r.uid] = tuple(tokens.shape)
        return lg, mini

    def spy_decode(params, cache, last_tok, lengths, masks, active):
        # a plain step produces token len(generated) + buf_fill of each
        # slot's request; a spec round's verify position t produces token
        # len(generated) + buf_len + t (later rounds overwrite what this
        # one did not commit). buf_len is zeroed in place at each sync:
        # keep a copy
        base = eng.slots.buf_len.clone() if eng.spec \
            else eng.slots.buf_fill
        captured.clear()
        out = decode(params, cache, last_tok, lengths, masks, active)
        steps.append((captured[-1], base, [
            None if r is None else (r.uid, len(r.generated))
            for r in eng.slot_req]))
        return out

    eng.scheduler.group_by_bucket = spy_groups
    eng.prefill_logits = spy_prefill
    eng.slots.decode_fn = spy_decode
    MDL.lm_logits = lm_logits

    def finish():
        MDL.lm_logits = lm
        for lg, base, slots in steps:
            base = base.tolist() if not isinstance(base, int) \
                else [base] * len(slots)
            for i, slot in enumerate(slots):
                if slot is not None:
                    uid, n = slot
                    for t in range(lg.shape[1]):
                        logits[(uid, n + base[i] + t)] = lg[i, t]
        steps.clear()
    return dict(logits=logits, shapes=shapes, finish=finish)


def cb_drain(torch, run, counters, reqs=None):
    """Drain phase 9's workload (or ``reqs``) through ``run``'s engine with
    the recorder's hooks on (they add no host sync), every kernel counter
    set to 0 just before and read just after: {eng, reqs, dt (seconds),
    launches, launches_by_t (#2's, by T), waves (each wave's
    last_admission), rec, stats (serve_stats()), peak_bytes, tok_s}."""
    from repro_torch.models import model as MDL
    from repro_torch.serve import Request

    eng = cb_engine(run["cfg"], run["params"], run["store"],
                    run["continuous"], **run["kw"])
    if reqs is None:
        reqs = skewed_requests(Request, run["cfg"].vocab_size,
                               n=run.get("n", 12), long_new=run["long_new"])
    waves = []
    hydrate = eng._hydrate_stacked

    def spy(wave):
        out = hydrate(wave)
        waves.append(dict(eng.last_admission))
        return out
    eng._hydrate_stacked = spy
    rec = cb_recorder(eng, MDL)
    for fn in counters.values():
        fn.launches = 0
    by_t = counters["fused_adapter_batched"].launches_by_t
    by_t.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        eng.run_until_drained(list(reqs))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    finally:
        rec["finish"]()
    launches = {name: fn.launches for name, fn in counters.items()}
    launches_by_t = dict(by_t)
    vocab = run["cfg"].vocab_size
    assert all(r.done and len(r.generated) == r.max_new_tokens
               for r in reqs)
    assert all(0 <= t < vocab for r in reqs for t in r.generated)
    if run["continuous"] and eng.page_alloc is not None:
        eng.page_alloc.check()
        if eng.mask_alloc is not None:
            eng.mask_alloc.check()
    return dict(eng=eng, reqs=reqs, dt=dt, launches=launches,
                launches_by_t=launches_by_t, waves=waves, rec=rec,
                stats=eng.serve_stats(),
                peak_bytes=torch.cuda.max_memory_allocated(),
                tok_s=sum(len(r.generated) for r in reqs) / dt)


def cb_explain(torch, out, ref):
    """Hold two recorded drains' tokens to each other: for each request
    whose tokens part, the first token where they part, the first recorded
    logits where the two runs differ at all (the prefill, with each run's
    prefill batch shape, or the decode step producing that token), the
    reference's top-2 gap there and that step's max |d logit|; the gap
    must be at most twice the max |d logit|."""
    agree = total = 0
    flips = []
    lo, lr = out["rec"]["logits"], ref["rec"]["logits"]
    # the premise: each run's recorded logits give every token it emitted
    for run in (out, ref):
        lg = run["rec"]["logits"]
        keys = [(r.uid, j) for r in run["reqs"]
                for j in range(len(r.generated))]
        picks = torch.stack([lg[k] for k in keys]).argmax(-1).tolist()
        assert picks == [t for r in run["reqs"] for t in r.generated]
    for r, q in zip(out["reqs"], ref["reqs"]):
        assert r.uid == q.uid
        pairs = list(zip(r.generated, q.generated))
        agree += sum(a == b for a, b in pairs)
        total += len(pairs)
        j = next((t for t, (a, b) in enumerate(pairs) if a != b), None)
        if j is None:
            continue
        first = next(t for t in range(j + 1)
                     if not torch.equal(lo[(r.uid, t)], lr[(r.uid, t)]))
        where = (f"the prefill (batch {out['rec']['shapes'][r.uid]} vs "
                 f"{ref['rec']['shapes'][r.uid]})" if first == 0
                 else f"the decode step producing token {first}")
        k_, r_ = lo[(r.uid, j)], lr[(r.uid, j)]
        top = r_.topk(2)
        gap = (top.values[0] - top.values[1]).item()
        d = (k_ - r_).abs().max().item()
        log(f"  first flip: request {r.uid}, token {j}: reference "
            f"{q.generated[j]}, this run {r.generated[j]}; the runs first "
            f"differ at {where}; reference top-2 gap {gap:.4e}, the step's "
            f"max|d logit| {d:.4e}")
        assert int(k_.argmax()) == r.generated[j], (r.uid, j)
        assert int(r_.argmax()) == q.generated[j], (r.uid, j)
        assert gap <= 2 * d, (r.uid, j, gap, d)
        flips.append(dict(uid=r.uid, token=j, first_diverging_token=first,
                          gap=gap, max_d_logit=d))
    return dict(agree=agree, total=total, flips=flips)


def cb_profile(torch, run, label):
    """One step of ``run``'s engine (a speculation round with spec) with 4
    live requests of 100 new tokens: 4 steps on the host clock, 2 under
    torch.profiler tracing the card only, for the device time by kernel
    (host op events would multiply its cost: a composed step launches
    ~2,700 kernels, a round 11,000); then the paged gather
    (``dense_view``) and the one-position writeback on this engine's
    pool, as CUDA-graph replays."""
    import numpy as np

    from repro_torch.serve import Request
    from repro_torch.serve import pages as PG

    eng = cb_engine(run["cfg"], run["params"], run["store"],
                    run["continuous"], **run["kw"])
    rng = np.random.default_rng(5)
    eng.submit([Request(uid=100 + i, prompt=rng.integers(
        0, run["cfg"].vocab_size, 8), profile_id=i % 3, max_new_tokens=100)
        for i in range(4)])
    eng.admit_many(eng.scheduler.next_batch(4))
    for _ in range(2):
        eng.step()
    eng.sync()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(4):
        eng.step()
    eng.sync()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / 4 * 1e3

    def steps():
        for _ in range(2):
            eng.step()
        eng.sync()

    rows = trace_card(torch, steps, f"phase 9 step {label}")
    dev = sum(e.self_device_time_total for e in rows) / 1e3 / 2
    n_kernels = sum(e.count for e in rows) / 2
    out = dict(step_wall_ms=wall, step_device_ms=dev,
               step_kernels=n_kernels, busy_share=dev / wall)
    if run["continuous"]:
        data, table = eng.cache["data"], eng.cache["table"]
        dense = PG.dense_view(data, table, CB_PAGE)
        lengths, active = eng.slots.lengths, eng.slots.active
        out["gather_ms"] = device_ms(
            torch, lambda: PG.dense_view(data, table, CB_PAGE), calls=16)
        # rewrites each live slot's next position with what its page holds
        out["writeback_ms"] = device_ms(
            torch, lambda: PG.writeback(data, dense, table, lengths, active,
                                        CB_PAGE), calls=16)
        out["gather_bytes"] = 2 * sum(v.numel() * v.element_size()
                                      for v in dense.values())
        out["kv_pool_bytes"] = eng.kv_pool_bytes()
    log(f"  {label} step (B=4): host wall {wall:.3f} ms without the "
        f"profiler; device {dev:.4f} ms in {n_kernels:.0f} kernels -> busy "
        f"share {dev / wall:.4f}"
        + (f"; paged gather {out['gather_ms']:.5f} ms ("
           f"{out['gather_bytes'] / 1e6:.2f} MB read and written), "
           f"writeback {out['writeback_ms']:.5f} ms per call; K/V pool "
           f"{out['kv_pool_bytes'] / 1e6:.2f} MB" if run["continuous"]
           else ""))
    return out


def phase_continuous(torch, cfg=None):
    """Phase 9: qwen1.5-0.5b at full width (bf16, bank N=256, b=64, k=50,
    random weights from seed 0), 4 slots, max_seq 128, page_size 16,
    sync_every 8, on ``benchmarks/cb_smoke.py``'s skewed workload (12
    requests). Each continuous run is held to its reference run token for
    token (first flips explained, see ``cb_explain``) and its launches
    counted per drain: (a) bf16 composed, continuous vs windowed; (b) the
    same continuous with long_new 100 and 10 pages (preemptions and
    resumes > 0) vs the unstarved pool; (c) decode_fused; (d) int8; (e)
    the hetero bank (phase 6's bank_spec, P=8), each continuous vs
    windowed; (f) spec gamma=3 vs (a)'s continuous run, and under (b)'s
    starved pool vs (b); (g) (a)'s continuous engine with 2 mask entries
    for 4 slots and ``max_wait_waves=2`` vs (a)'s continuous run."""
    from repro_torch.configs import get_config
    from repro_torch.core import xpeft as XP
    from repro_torch.core.profiles import ProfileStore
    from repro_torch.models import init_lm

    t_phase = time.perf_counter()
    cfg = cfg or get_config("qwen1.5-0.5b")
    xp, L = cfg.xpeft, cfg.num_layers
    counters = kernel_counters()
    params = init_lm(cfg, seed=0, device="cuda")
    table = XP.init_profile_table(cfg.with_xpeft(max_profiles=4), seed=0)

    def store_for(c, **kw):
        s = ProfileStore(c.num_layers, xp.num_adapters, xp.bottleneck,
                         xp.mask_type, xp.k, **kw)
        for pid in range(4):
            s.add_profile(pid, {k: v[pid] for k, v in table.items()})
        return s

    store = store_for(cfg)
    q_cfg = cfg.with_xpeft(bank_quant="int8")
    q_store = store_for(q_cfg, quant="int8", quant_group=xp.quant_group)
    h_cfg = cfg.with_xpeft(bank_spec=HETERO_SPEC, prefix_tokens=HETERO_P)
    h_params, h_store, _ = hetero_setup(torch, h_cfg)
    s_cfg = cfg.with_(spec_enable=True, spec_gamma=CB_GAMMA)
    c_cfg = cfg.with_(decode_fused=True)

    def run(cfg_, params_, store_, continuous, long_new=40, **kw):
        return dict(cfg=cfg_, params=params_, store=store_,
                    continuous=continuous, long_new=long_new, kw=kw)

    runs = {
        "a_windowed": run(cfg, params, store, False),
        "a": run(cfg, params, store, True),
        "b_unstarved": run(cfg, params, store, True, long_new=100),
        "b": run(cfg, params, store, True, **CB_STARVED),
        "c_windowed": run(c_cfg, params, store, False),
        "c": run(c_cfg, params, store, True),
        "d_windowed": run(q_cfg, params, q_store, False),
        "d": run(q_cfg, params, q_store, True),
        "e_windowed": run(h_cfg, h_params, h_store, False),
        "e": run(h_cfg, h_params, h_store, True),
        "f": run(s_cfg, params, store, True),
        "f_starved": run(s_cfg, params, store, True, **CB_STARVED),
        "g": run(cfg, params, store, True, **CB_ENTRIES),
    }
    # (run, its reference)
    pairs = (("a", "a_windowed"), ("b", "b_unstarved"), ("c", "c_windowed"),
             ("d", "d_windowed"), ("e", "e_windowed"), ("f", "a"),
             ("f_starved", "b"), ("g", "a"))

    def expect(name, n, by_t, st, waves):
        """What each run must launch per drain (``by_t``: #2's launches by
        T)."""
        steps, batches = st["device_steps"], st["prefill_batches"]
        sparse = sum(w["path"] == "sparse" for w in waves)
        zero = set(n)
        if name[0] == "c":
            assert n["decode_block_fused"] == L * steps > 0, n
            assert n["fused_adapter_batched"] == L * batches, n
            assert n["mask_aggregate_batched"] == 2 * sparse > 0, n
            zero -= {"decode_block_fused", "fused_adapter_batched",
                     "mask_aggregate_batched"}
        elif name[0] == "d":
            quant = sum(w["path"] == "quant_sparse" for w in waves)
            assert n["mask_aggregate_quant_batched"] == 2 * quant > 0, n
            assert n["fused_adapter_quant_batched"] == \
                L * (steps + batches), n
            zero -= {"mask_aggregate_quant_batched",
                     "fused_adapter_quant_batched"}
        elif name[0] == "e":
            assert n["mask_aggregate_batched"] == 10 * sparse > 0, n
            assert n["hetero_adapter_batched"] == L * (steps + batches), n
            zero -= {"mask_aggregate_batched", "hetero_adapter_batched"}
        else:
            # spec rounds: gamma zero-record drafts and the verify, each
            # through #2 in every layer
            per_step = CB_GAMMA + 1 if name[0] == "f" else 1
            assert n["fused_adapter_batched"] == \
                L * (per_step * steps + batches) > 0, n
            # the verifies are #2's only T=gamma+1 launches (prefill
            # batches pad to 8 tokens or more)
            assert by_t.get(CB_GAMMA + 1, 0) == \
                (L * steps if name[0] == "f" else 0), by_t
            assert n["mask_aggregate_batched"] == 2 * sparse > 0, n
            zero -= {"fused_adapter_batched", "mask_aggregate_batched"}
        assert not any(n[k] for k in zero), n

    done, warm, results = {}, set(), {}
    for name, ref_name in pairs:
        for key in (ref_name, name):
            if key in done:
                continue
            r = runs[key]
            if (id(r["cfg"]), r["continuous"]) not in warm:
                # warm-up: a short drain of the same engine shape
                warm.add((id(r["cfg"]), r["continuous"]))
                cb_drain(torch, dict(r, n=4, long_new=4, kw={}), counters)
            done[key] = cb_drain(torch, r, counters)
        out, ref = done[name], done[ref_name]
        eng, st, rst = out["eng"], out["eng"].serve_stats(), \
            ref["eng"].serve_stats()
        expect(name, out["launches"], out["launches_by_t"], st,
               out["waves"])
        expect(ref_name, ref["launches"], ref["launches_by_t"], rst,
               ref["waves"])
        toks = sum(len(q.generated) for q in out["reqs"])
        label = f"({name}) vs ({ref_name})"
        agreement = cb_explain(torch, out, ref)
        log(f"phase 9 {label}: tokens agree {agreement['agree']}/"
            f"{agreement['total']} ({len(agreement['flips'])} requests "
            f"part); {len(out['reqs'])} requests / {toks} tokens in "
            f"{out['dt']:.3f}s = {toks / out['dt']:.1f} tok/s (reference "
            f"{toks / ref['dt']:.1f})")
        spec = st.get("spec", {})
        log(f"  stats: mode {st['mode']}, device steps {st['device_steps']} "
            f"(reference {rst['device_steps']}), stranded slot steps "
            f"{st['stranded_slot_steps']} (reference "
            f"{rst['stranded_slot_steps']}), slot occupancy "
            f"{st['slot_occupancy']}, committed per device step "
            f"{st['committed_per_device_step']}, spec acceptance "
            f"{spec.get('acceptance_rate', 'n/a')}, preemptions "
            f"{st.get('preemptions', 0)}, resumes {st.get('resumes', 0)}; "
            f"launches per drain {out['launches']}")
        if name in ("a", "c", "d", "e"):
            assert st["stranded_slot_steps"] < rst["stranded_slot_steps"]
            assert st["device_steps"] < rst["device_steps"]
        if name in ("b", "f_starved"):
            assert st["preemptions"] > 0 and st["resumes"] > 0, st
        if name[0] == "f":
            assert st["committed_per_device_step"] > 1.0, st
            assert st["device_steps"] < rst["device_steps"], (st, rst)
        eng.page_alloc.check()
        eng.mask_alloc.check()
        results[name] = dict(
            reference=ref_name, tok_s=toks / out["dt"],
            reference_tok_s=toks / ref["dt"], launches=out["launches"],
            verify_launches=out["launches_by_t"].get(CB_GAMMA + 1, 0),
            reference_launches=ref["launches"], **agreement,
            **{k: st[k] for k in (
                "device_steps", "stranded_slot_steps", "slot_occupancy",
                "committed_per_device_step", "preemptions", "resumes",
                "pages", "mask_entries", "scheduler", "prefill_batches")},
            reference_device_steps=rst["device_steps"],
            reference_stranded_slot_steps=rst["stranded_slot_steps"],
            spec=spec or None)
        if name == "g":
            # fewer entries than slots: requests wait at the queue's head
            # for an entry, so the drain takes at least (a)'s steps
            me, sch = st["mask_entries"], st["scheduler"]
            assert me["n_pages"] == CB_ENTRIES["mask_pages"], me
            assert me["high_water"] <= CB_ENTRIES["mask_pages"], me
            assert me["oom_events"] > 0 and sch["requeued"] > 0, st
            assert st["device_steps"] >= rst["device_steps"], (st, rst)
            pool = sum(v.numel() * v.element_size()
                       for v in eng.masks["pool"].values())
            ref_pool = sum(v.numel() * v.element_size()
                           for v in ref["eng"].masks["pool"].values())
            results[name].update(
                tokens_bitwise=not agreement["flips"], mask_pool_bytes=pool,
                reference_mask_pool_bytes=ref_pool,
                entry_bytes=pool // me["n_pages"])
            log(f"  (g) mask entries {me}; scheduler {sch}; tokens "
                f"{'bitwise' if not agreement['flips'] else 'not bitwise'}"
                f" (a)'s; {toks / out['dt']:.1f} tok/s, "
                f"{st['device_steps']} device steps, "
                f"{st['stranded_slot_steps']} stranded slot steps against "
                f"(a)'s {toks / ref['dt']:.1f}, {rst['device_steps']}, "
                f"{rst['stranded_slot_steps']}; entry pool "
                f"{pool / 1e6:.3f} MB ({pool // me['n_pages']} B an entry) "
                f"against (a)'s {ref_pool / 1e6:.3f} MB")
    results["c16"] = cb_sixteen(torch, cfg, params, store, counters)
    t_profile = time.perf_counter()
    for name in ("a", "c", "d", "e", "f"):
        results[name].update(cb_profile(torch, runs[name], f"({name})"))
    # the starved runs (pages or entries) are not profiled (their steps
    # have (a)'s and (f)'s shapes): their host ms per step is the drain's
    # wall over its steps, admission and swaps included; their device
    # fields stay null
    for name in ("b", "f_starved", "g"):
        r = results[name]
        r.update({k: None for k in (
            "step_wall_ms", "step_device_ms", "step_kernels", "busy_share",
            "gather_ms", "writeback_ms", "gather_bytes")},
            drain_ms_per_step=done[name]["dt"] * 1e3 / r["device_steps"],
            kv_pool_bytes=done[name]["eng"].kv_pool_bytes())
        log(f"  ({name}) drain {r['drain_ms_per_step']:.3f} ms of host "
            f"time per device step (admission and swaps included); not "
            f"profiled; K/V pool {r['kv_pool_bytes'] / 1e6:.2f} MB")
    results["a"]["windowed_kv_bytes"] = done["a_windowed"]["eng"] \
        .kv_pool_bytes()
    end = time.perf_counter()
    results["seconds"] = end - t_phase
    results["profile_seconds"] = end - t_profile
    results["drain_seconds"] = sum(d["dt"] for d in done.values())
    log(f"phase 9: {results['seconds']:.1f}s ({results['drain_seconds']:.1f}"
        f"s in the {len(done)} timed drains, "
        f"{results['profile_seconds']:.1f}s profiling)")
    return results


def cb_sixteen(torch, cfg, params, store, counters):
    """Phase 9 (c16): ``decode_fused`` on a windowed engine of 16 slots
    (#8 launched once per group of at most 8 slots a layer), 16 of phase
    9's requests, against the composed engine of as many slots.
    Every decode step must run the megakernel (#8 L x groups times a
    step; #2 only in prefill, L times a batch: no composed decode step
    ran); the tokens are held to the composed run's under the flip rule
    (``cb_explain``)."""
    from repro_torch.kernels.decode_fused import slot_groups

    slots = 16
    L, groups = cfg.num_layers, len(slot_groups(slots))
    kw = dict(max_slots=slots)

    def run(c):
        return dict(cfg=c, params=params, store=store, continuous=False,
                    long_new=40, kw=kw, n=16)
    fused, composed = run(cfg.with_(decode_fused=True)), run(cfg)
    for r in (fused, composed):
        cb_drain(torch, dict(r, n=slots, long_new=4), counters)  # warm-up
    out, ref = (cb_drain(torch, r, counters) for r in (fused, composed))
    n, st = out["launches"], out["stats"]
    steps, batches = st["device_steps"], st["prefill_batches"]
    sparse = sum(w["path"] == "sparse" for w in out["waves"])
    assert n["decode_block_fused"] == L * groups * steps > 0, n
    assert n["fused_adapter_batched"] == L * batches, n
    assert n["mask_aggregate_batched"] == 2 * sparse > 0, n
    assert not any(v for k, v in n.items() if k not in (
        "decode_block_fused", "fused_adapter_batched",
        "mask_aggregate_batched")), n
    rn, rst = ref["launches"], ref["stats"]
    assert rn["decode_block_fused"] == 0, rn
    assert rn["fused_adapter_batched"] == \
        L * (rst["device_steps"] + rst["prefill_batches"]) > 0, rn
    agreement = cb_explain(torch, out, ref)
    toks = sum(len(q.generated) for q in out["reqs"])
    log(f"phase 9 (c16) decode_fused at {slots} slots ({groups} launches of "
        f"#8 a layer) vs composed at {slots}: tokens agree "
        f"{agreement['agree']}/{agreement['total']} "
        f"({len(agreement['flips'])} requests part); {toks} tokens in "
        f"{steps} device steps, {out['dt']:.3f}s = {out['tok_s']:.1f} tok/s "
        f"(composed {ref['tok_s']:.1f}); launches {n}")
    return dict(reference="composed windowed, 16 slots", slots=slots,
                launches=n, reference_launches=rn, tok_s=out["tok_s"],
                reference_tok_s=ref["tok_s"], device_steps=steps,
                prefill_batches=batches, **agreement)


TRACE_TRIES = 3


def trace_card(torch, run, label, again=None, tries=TRACE_TRIES):
    """The card's rows of ``key_averages()`` for one call of ``run`` (which
    does the work to trace) under torch.profiler tracing the card only.
    CUPTI has handed back an empty trace for one session of a whole run
    on an H100 (phase 10 (d)) where other runs of the same code traced
    every session, so an empty trace is taken again under a new profiler,
    after ``again()`` (re-arms the state ``run`` consumes, outside the
    trace) where given, up to ``tries`` times; each empty try is logged.
    It fails when no try traced a kernel."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(tries):
        if i and again is not None:
            again()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.count for e in rows) > 0 and \
                sum(e.self_device_time_total for e in rows) > 0:
            return rows
        log(f"{label}: the profiler traced no kernel (try {i + 1} of "
            f"{tries})")
    raise AssertionError(f"{label}: the profiler traced no kernel in "
                         f"{tries} tries")


def profile_decode(torch, ServeEngine, Request, cfg, params, store, label,
                   eng_kw=None, steps=(3, 4, 8), profiles=4, reqs=None):
    """Where a decode step's time goes (B=4 slots, T=1): after
    ``steps[0]`` warm-up steps, ``steps[1]`` steps timed on the host clock
    without the profiler, then ``steps[2]`` steps (one window's sync
    included) under torch.profiler tracing the card only (host op events
    would cost seconds a step) for the device time by kernel
    (``trace_card``: an empty trace is retaken on a new engine brought to
    the same step). ``eng_kw`` may override the engine's shape (4 slots,
    max_seq 128, sync_every 8); ``reqs``: the 4 requests (default
    ``make_requests``')."""
    import copy

    warm, timed, traced = steps
    box, given = {}, copy.deepcopy(reqs)

    def ready():
        """A new engine with unused copies of the 4 requests, ``warm +
        timed`` steps in; the host ms of its timed steps."""
        eng = ServeEngine(cfg, params, store, **{
            **dict(max_slots=4, max_seq=128, sync_every=8),
            **(eng_kw or {})})
        eng.submit(copy.deepcopy(given) or make_requests(
            Request, cfg.vocab_size, n=4, profiles=profiles))
        eng.admit_many(eng.scheduler.next_batch(4))
        for _ in range(warm):
            eng.step()
        eng.sync()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(timed):
            eng.step()
        eng.sync()
        torch.cuda.synchronize()
        box["eng"] = eng
        return (time.perf_counter() - t) / timed * 1e3

    def run():
        for _ in range(traced):
            box["eng"].step()
        box["eng"].sync()

    wall = ready()
    rows = trace_card(torch, run, f"decode step {label}", again=ready)
    dev = sum(e.self_device_time_total for e in rows) / 1e3 / traced
    n_kernels = sum(e.count for e in rows) / traced
    log(f"decode step {label} (B=4, T=1): host wall {wall:.3f} ms/step "
        f"without the profiler; device {dev:.4f} ms/step in "
        f"{n_kernels:.0f} kernels -> "
        f"device busy share {dev / wall:.4f}; top kernels by device time:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3 / traced:.4f} ms/step "
            f"{e.count / traced:5.0f} launches/step  {e.key[:72]}")
    return dict(decode_wall_ms=wall, decode_device_ms=dev,
                decode_kernels=n_kernels)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_fused as KD
    from repro_torch.kernels import fused_adapter as KF1
    from repro_torch.kernels import fused_adapter_batched as KF
    from repro_torch.kernels import fused_adapter_quant as KFQ
    from repro_torch.kernels import hetero_adapter as KH
    from repro_torch.kernels import ia3_apply as KI
    from repro_torch.kernels import mask_aggregate as KA
    from repro_torch.kernels import mask_aggregate_quant as KAQ
    from repro_torch.kernels import ref
    from repro_torch.quant import schemes as QS

    # 1. device; each numbered step's wall seconds go to phase_seconds
    phase_seconds, lap_start = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_seconds[name] = now - lap_start[0]
        lap_start[0] = now

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | capability "
        f"{torch.cuda.get_device_capability(0)}")

    # 2. build
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    _build.load_library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f}s")
    lap("1-2 device and build")

    # 3. kernels
    agg = phase_mask_aggregate(torch, KA, ref, F)
    fa = phase_fused_adapter(torch, KF, ref)
    dec = phase_decode_block(torch, KD, ref, get_config("qwen1.5-0.5b"),
                             QS)
    one = phase_unbatched(torch, KA, KF1, ref, F)
    aggq = phase_mask_aggregate_quant(torch, KAQ, ref, QS)
    faq = phase_fused_adapter_quant(torch, KFQ, ref, QS)
    lap("3 kernels")

    # 4. serve: the composed decode path, the entry points of #3 and #4,
    # then the decode megakernel path
    launches, serve, ctx = phase_serve(torch, KA, KF)
    entry_launches = phase_entry_points(torch, KA, KF1, ctx)
    fused_launches, serve_fused = phase_serve_fused(torch, KA, KF, KD, ctx)
    lap("4 serve")
    # 5. serve from a quantized bank, each path with the counters set to 0
    # just before it
    quant = {}
    for scheme in ("int8", "int4"):
        for fused in (False, True):
            quant[(scheme, fused)] = phase_serve_quant(
                torch, KAQ, KFQ, KD, KA, KF, ctx, scheme, fused)
    lap("5 serve quantized")
    # 6. heterogeneous bank: #7, the hetero-adapter launch, #2's LoRA route
    # and #1's typed shapes on their own, then the serving path
    ia3 = phase_ia3(torch, KI, ref)
    hetero = phase_hetero_adapter(torch, KH, KF, KI, ref)
    lora, agg_typed = phase_hetero_kernels(torch, KA, KF, ref)
    hetero_launches, serve_hetero, ia3_launches = phase_serve_hetero(
        torch, KA, KF, KI, KH, KAQ, KFQ, KD, ctx)
    lap("6 hetero")
    # 7. training: one step on the card against the CPU, ten full-depth
    # steps through the launcher's loop, the trained profiles packed,
    # saved and reloaded, then served per step and from soft masks
    # (phase 4's weights are kept for phase 11)
    base = dict(params=ctx["params"])
    del ctx
    torch.cuda.empty_cache()
    train_step = phase_train_step_vs_cpu(torch)
    trained, train = phase_train_full(torch)
    stores = phase_pack_reload(torch, trained)
    serve_per_step, serve_per_step_fused, serve_soft = phase_serve_trained(
        torch, KA, KF, KD, trained, stores)
    lap("7 train")
    # 8. the paper's encoder: train at the paper's shape, pack, reload,
    # evaluate from the store, then admit the store through #1 and #2
    del trained, stores
    torch.cuda.empty_cache()
    encoder = phase_encoder(torch)
    lap("8 encoder")
    # 9. continuous batching and self-speculation, each run with the
    # counters set to 0 just before its drain; phases 9 and 10 run
    # qwen1.5-0.5b at full width and CUT_LAYERS of its 24 layers
    torch.cuda.empty_cache()
    cut = get_config("qwen1.5-0.5b").with_(num_layers=CUT_LAYERS)
    continuous = phase_continuous(torch, cfg=cut)
    lap("9 continuous")
    # 18. the float8_e4m3fn KV cache: #8 reading and writing it against
    # its plain version, then windowed and continuous drains on phase 4's
    # weights (views of their first CUT_LAYERS layers), each run with the
    # counters set to 0 just before it
    torch.cuda.empty_cache()
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import kv_f8_phase
    kv_f8 = kv_f8_phase.phase_kv_f8(torch, params=base["params"])
    lap("18 float8 cache")
    # 10. heterogeneous training forms, per-step heterogeneous serving,
    # fault plans with degraded admission, observability (each run with
    # the counters set to 0 just before it)
    torch.cuda.empty_cache()
    import resilience_phase
    resilience = resilience_phase.phase_resilience(torch, cfg=cut)
    lap("10 resilience")
    # 11. the profile lifecycle: onboarding through the roster, checkpoint
    # and resume, the gang step against the CPU, the graduated store served
    torch.cuda.empty_cache()
    import lifecycle_phase
    lifecycle = lifecycle_phase.phase_lifecycle(torch, base=base,
                                                layers=CUT_LAYERS)
    del base
    lap("11 lifecycle")
    # 12. mixture-of-experts blocks: qwen3-moe-30b-a3b at full width and
    # depth (~67.5 GB with its bank), so nothing else stays on the card
    gc.collect()
    torch.cuda.empty_cache()
    import moe_phase
    moe = moe_phase.phase_moe(torch)
    lap("12 moe")
    # 13. the attention forms (gemma-2b, gemma3-27b cut to 12 layers,
    # musicgen-medium) and #8's GLU-GELU and wide-row builds, with
    # nothing else held on the card
    gc.collect()
    torch.cuda.empty_cache()
    import forms_phase
    forms = forms_phase.phase_forms(torch)
    lap("13 forms")
    # 14. the recurrent block families (rwkv6-7b at full width, zamba2-1.2b
    # at full size) on the chunked linear attention, nothing else held
    gc.collect()
    torch.cuda.empty_cache()
    import recurrent_phase
    recurrent = recurrent_phase.phase_recurrent(torch)
    lap("14 recurrent")
    # 15. multi-device serving: a world-1 NCCL mesh in this process, then
    # two processes on the one card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    import mesh_phase
    mesh = mesh_phase.phase_mesh(torch)
    lap("15 mesh")
    # 16. multi-device training: a world-1 NCCL mesh in this process, the
    # MoE reference, then two processes on the one card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    import mesh_train_phase
    mesh_train = mesh_train_phase.phase_mesh_train(torch)
    lap("16 mesh train")
    # 17. the dry run's resident bytes against the allocator and its
    # decode step's peak against the card's (the kernels' launches counted
    # from 0), then cfg.remat none / full / dots on the card
    gc.collect()
    torch.cuda.empty_cache()
    import dryrun_phase
    dryrun = dryrun_phase.phase_dryrun(torch)
    lap("17 dry run")

    kernels = []
    for name, rows, src, tpu, n in (
            ("mask_aggregate_batched", agg,
             "src/repro_torch/csrc/mask_aggregate.cu",
             "src/repro/kernels/mask_aggregate.py:74",
             launches["mask_aggregate_batched"]),
            ("fused_adapter_batched", fa,
             "src/repro_torch/csrc/fused_adapter.cu",
             "src/repro/kernels/fused_adapter_batched.py:65",
             launches["fused_adapter_batched"]),
            ("fused_adapter", [one["fused_adapter"]],
             "src/repro_torch/csrc/fused_adapter.cu",
             "src/repro/kernels/fused_adapter.py:46",
             entry_launches["fused_adapter"]),
            ("mask_aggregate", [one["mask_aggregate"]],
             "src/repro_torch/csrc/mask_aggregate.cu",
             "src/repro/kernels/mask_aggregate.py:47",
             entry_launches["mask_aggregate"]),
            # the path's own shape first: route bf16 at qwen's KV heads;
            # routes int8/int4 (launched on the quantized decode_fused
            # paths) among the other shapes
            ("decode_block_fused", [dec[1], dec[0]] + dec[2:],
             "src/repro_torch/csrc/decode_fused.cu",
             "src/repro/kernels/decode_fused.py:219",
             fused_launches["decode_block_fused"]),
            # admission of the composed int8 path: two launches per wave
            # that aggregates
            ("mask_aggregate_quant_batched", aggq,
             "src/repro_torch/csrc/mask_aggregate_quant.cu",
             "src/repro/kernels/mask_aggregate_quant.py:48",
             quant[("int8", False)][0]["mask_aggregate_quant_batched"]),
            ("fused_adapter_quant_batched", faq,
             "src/repro_torch/csrc/fused_adapter_quant.cu",
             "src/repro/kernels/fused_adapter_quant.py:53",
             quant[("int8", False)][0]["fused_adapter_quant_batched"]),
            # IA3-only entries, through forward: 24 launches (none on the
            # hetero path, where the hetero-adapter launch takes IA3)
            ("ia3_apply_batched", ia3, "src/repro_torch/csrc/ia3_apply.cu",
             "src/repro/kernels/ia3_apply.py:45", ia3_launches),
            # the hetero path: 24 launches per decode step and prefill
            # batch, #7's redesign
            ("hetero_adapter_batched", hetero,
             "src/repro_torch/csrc/fused_adapter.cu",
             "src/repro/kernels/ia3_apply.py:45",
             hetero_launches["hetero_adapter_batched"])):
        main_row = rows[0]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": tpu, "launches": n}
        entry.update({k: main_row[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        entry["shape"] = main_row["shape"]
        entry["other_shapes"] = rows[1:]
        kernels.append(entry)
    # each quantized route's launches on its own path's run
    kernels[4]["other_shapes"][2]["launches"] = \
        quant[("int8", True)][0]["decode_block_fused"]
    kernels[4]["other_shapes"][3]["launches"] = \
        quant[("int4", True)][0]["decode_block_fused"]
    # the hetero path's shapes of #1 and #2, each with its own launches
    # on that path (the LoRA row's count covers T=1 and T=16 together)
    by_shape = serve_hetero["launches_by_shape"]
    for row in agg_typed:
        row["launches"] = by_shape[row["shape"]]
    kernels[0]["other_shapes"] += agg_typed
    kernels[1]["other_shapes"] += [
        dict(shape=f"LoRA route T={T}", max_abs_err=err,
             launches=by_shape["lora"])
        for T, err in lora.items()]
    kernels[7]["launches_hetero_path"] = hetero_launches["ia3_apply_batched"]
    # the training phase's serving paths: per-step serving launches no
    # kernel of the path; soft-mask serving #2 alone
    for row in kernels[:2] + kernels[4:5]:
        row["launches_per_step_path"] = serve_per_step["launches"][
            row["name"]]
        row["launches_soft_path"] = serve_soft["launches"][row["name"]]
    # the encoder path (phase 8 (e)): #1 twice, #2 once per layer, at
    # the shapes of the rows marked "encoder" (#2: its B=64 T=128 row)
    enc_launches = encoder["kernels"]["launches"]
    for row in kernels:
        row["launches_encoder_path"] = enc_launches[row["name"]]
    for row in kernels[0]["other_shapes"]:
        if row["shape"].startswith("encoder"):
            row["launches_encoder_path"] = enc_launches[kernels[0]["name"]]
    for row in kernels[1]["other_shapes"]:
        if row["shape"].startswith("encoder B=64 T=128"):
            row["launches_encoder_path"] = enc_launches[kernels[1]["name"]]
    # phase 9: every kernel's launches per drain of each continuous run;
    # #2's verify row: the spec runs' T=gamma+1 launches, as counted
    for row in kernels:
        row["launches_continuous"] = {
            run: continuous[run]["launches"][row["name"]]
            for run in ("a", "b", "c", "d", "e", "f", "f_starved", "g",
                        "c16")}
    # #8's 16-slot rows: launches on phase 9's 16-slot decode_fused drain
    for row in kernels[4]["other_shapes"]:
        if row["shape"].startswith("B=16"):
            row["launches"] = continuous["c16"]["launches"][
                "decode_block_fused"]
    for row in kernels[1]["other_shapes"]:
        if row["shape"].startswith("verify"):
            row["launches_continuous"] = {
                run: continuous[run]["verify_launches"]
                for run in ("f", "f_starved")}
    # phase 10: each kernel's launches on each of its runs
    p10 = {"hetero_trained": resilience["hetero_train"]["served"][
        "launches"]}
    p10.update({f"faults_{k}": v["launches"]
                for k, v in resilience["faults"].items()})
    p10.update({f"obs_{k}": v["launches"]
                for k, v in resilience["obs"].items()})
    for row in kernels:
        row["launches_phase10"] = {run: n.get(row["name"], 0)
                                   for run, n in p10.items()}
        # phase 11: serving the graduated store
        row["launches_phase11"] = lifecycle["served"]["launches"].get(
            row["name"], 0)
    # phase 12: each kernel's launches on each MoE run; #1, #2, #5 and #6
    # at the MoE shapes (d=2048, b=64), each row with its path's launches
    for row in kernels:
        row["launches_moe"] = {run: n.get(row["name"], 0)
                               for run, n in moe["runs"].items()}
    for i, key in ((0, "agg"), (1, "fa"), (5, "aggq"), (6, "faq")):
        for row in moe["kernel_rows"][key]:
            row["launches_moe"] = kernels[i]["launches_moe"]
        kernels[i]["other_shapes"] += moe["kernel_rows"][key]
    # phase 13: each kernel's launches on each run; #8 at its new
    # instantiations, #1 and #2 at gemma3-27b's shapes
    for row in kernels:
        row["launches_forms"] = {run: n.get(row["name"], 0)
                                 for run, n in forms["runs"].items()}
    for i, key in ((0, "agg"), (1, "fa"), (4, "dec"), (6, "faq")):
        for row in forms["kernel_rows"][key]:
            row["launches_forms"] = kernels[i]["launches_forms"]
        kernels[i]["other_shapes"] += forms["kernel_rows"][key]
    # phase 14: each kernel's launches on each run; #1, #2, #5, #6 and the
    # hetero launch at rwkv6-7b's d=4096
    for row in kernels:
        row["launches_recurrent"] = {run: n.get(row["name"], 0)
                                     for run, n in recurrent["runs"].items()}
    for i, key in ((0, "agg"), (1, "fa"), (5, "aggq"), (6, "faq"),
                   (8, "hetero")):
        for row in recurrent["kernel_rows"][key]:
            row["launches_recurrent"] = kernels[i]["launches_recurrent"]
        kernels[i]["other_shapes"] += recurrent["kernel_rows"][key]
    # phase 15: each kernel's launches on each (a) mesh run and on rank 0
    # of each (b) mesh
    for row in kernels:
        row["launches_mesh"] = {run: n.get(row["name"], 0)
                                for run, n in mesh["runs"].items()}
        row["launches_mesh_b"] = {run: n.get(row["name"], 0)
                                  for run, n in mesh["runs_b"].items()}
        # phase 16: the resumed drill's store served on the 1x1 mesh
        row["launches_mesh_train"] = {
            run: n.get(row["name"], 0)
            for run, n in mesh_train["runs"].items()}
        # phase 17 (a): the card's decode step beside the dry run's
        row["launches_dryrun"] = dryrun["a"]["launches"][row["name"]]
        # phase 18: each float8-cache run
        row["launches_kv_f8"] = {run: n.get(row["name"], 0)
                                 for run, n in kv_f8["runs"].items()}
    kernels[8]["sequence_ms"] = hetero[0]["sequence_ms"]
    # #8's float8-cache build (phase 18): its launches on the float8
    # decode_fused drain; (a)'s rows, the path's own shape first
    f8_rows = kv_f8["kernel_rows"]
    f8_entry = {"name": "decode_block_fused (float8_e4m3fn cache)",
                "route": "cuda", "source": kernels[4]["source"],
                "replaces": kernels[4]["replaces"],
                "launches": kv_f8["runs"]["b_decode_fused"][
                    "decode_block_fused"]}
    f8_entry.update({k: f8_rows[0][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "shape")})
    f8_entry["other_shapes"] = f8_rows[1:]
    f8_entry["launches_kv_f8"] = kernels[4]["launches_kv_f8"]
    kernels.append(f8_entry)
    serve_hetero["launches"] = hetero_launches
    serve_fused["launches"] = fused_launches
    serve_quant = {}
    for (scheme, fused), (n, row) in quant.items():
        row["launches"] = n
        serve_quant[f"{scheme}_{'decode_fused' if fused else 'composed'}"] \
            = row
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_seconds.items()))
    log(json.dumps({"train": dict(train, step_vs_cpu=train_step)}))
    log(json.dumps({"encoder": encoder}))
    log(json.dumps({"lifecycle": lifecycle}, default=str))
    log(json.dumps({"moe": {k: v for k, v in moe.items()
                            if k != "kernel_rows"}}, default=str))
    log(json.dumps({"forms": {k: v for k, v in forms.items()
                              if k not in ("kernel_rows", "decode_rows")}},
                   default=str))
    log(json.dumps({"recurrent": {k: v for k, v in recurrent.items()
                                  if k != "kernel_rows"}}, default=str))
    log(json.dumps({"mesh": mesh}, default=str))
    log(json.dumps({"mesh_train": mesh_train}, default=str))
    log(json.dumps({"dryrun": dryrun}, default=str))
    log(json.dumps({"kv_f8": {k: v for k, v in kv_f8.items()
                              if k != "kernel_rows"}}, default=str))
    log(json.dumps({"kernels": kernels, "serve": serve,
                    "serve_decode_fused": serve_fused,
                    "serve_quant": serve_quant,
                    "serve_hetero": serve_hetero,
                    "serve_per_step": serve_per_step,
                    "serve_per_step_decode_fused": serve_per_step_fused,
                    "serve_soft": serve_soft,
                    "serve_continuous": continuous,
                    "resilience": resilience,
                    "phase_seconds": phase_seconds}, default=str))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
