#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # build, kernel checks, full-width serve
                                     # and cold start
    python3 chip_smoke.py --quick    # build and kernel checks only
    python3 chip_smoke.py --prefill-profile   # build, then the prefill
                                     # profiles of phases 3 and 5 alone
    python3 chip_smoke.py --decode-shape      # build, then both decode
                                     # kernels at the engine's decode step
    python3 chip_smoke.py --wkv6-shape        # build, then the wkv6 kernel
                                     # at rwkv6-1.6b's prefill and decode
    python3 chip_smoke.py --tier      # build, then phase 7 alone
    python3 chip_smoke.py --fleet     # build, then phase 8 alone
    python3 chip_smoke.py --families  # build, then phase 9 alone
    python3 chip_smoke.py --encdec-vlm  # build, then phase 10 alone
    python3 chip_smoke.py --train     # build, then phase 11 alone
    python3 chip_smoke.py --dist      # build, then phase 12 alone
    python3 chip_smoke.py --append-skip  # build, then phase 13 alone

Run from the root of a checkout. Phases:

1. build: ``nvcc`` compiles every ``src/repro_torch/csrc/*.cu`` for sm_90a
   (one process per source, started together) and prints what ptxas
   reports per kernel.
2. kernels: each CUDA kernel at the main path's shapes (Hq 32, Hkv 8,
   hd 128, page 16) against its plain PyTorch version in float32 on the
   same inputs: the ragged kernel on a mixed batch (two prefill chunks with
   history, four decode rows, pad tiles) with bf16, fp16 and int8 pages
   and at a fused decode-only step (the four decode rows alone, bf16 and
   int8 pages; printed as ``RAGGED_DECODE``, whose bf16 output must equal
   the paged decode kernel's bit for bit on the same rows; each ragged
   line names the body and span tile its launch reported), the paged
   decode kernel at
   batch 4 with kv_len up to 1,024, flash
   attention at batch 1, causal, Sq = Sk = 300 and 412, and the contiguous
   decode kernel at batch 4, S 1,024, kv_len 1,024/777/300/1 (and a
   kv_len 0 row, exactly 0); both decode kernels again at the engine's
   own decode step (batch 4, kv_len 316/273/428/206: the serve's four
   prompts 16 tokens in) and at kv_len 1,024/777/300/1, each under the
   engine's table of 65 pages and S 1,024 (printed as ``DECODE``); and
   the WKV6 recurrence at rwkv6-1.6b's shapes (H 32, hd 64, bf16 r/k/v,
   float32 w and u: prefills of B 1, T 412 and 300 from a zero and a
   random state, a decode step of B 4, T 1 with its state written in
   place; printed as ``WKV6``), each output row (token, head) held to
   2^-7 of its largest |value| plus 1e-4 (bf16 output rounding is at most
   2^-8 of it) and a WKV6 final state to 1e-4 of its largest |value|; and f32
   cases at hd 16 held to 1e-5 with TF32 off. Times (CUDA events, median of
   repeats, L2 flushed before each) of the kernel, its plain version and
   one PyTorch library call for the same function where there is one (SDPA
   on gathered K/V, never called by the port; none computes WKV6), beside
   the least time the card could take.
3. serve: full-depth, full-width granite-3-8b (40 layers, d 4096, bf16) on
   random weights from a seeded generator. A ``ServingEndpoint`` over a
   2-stage paged engine serves 4 requests (prefill_chunk 256, max_new 32),
   is consolidated to one stage after a few decode steps and runs to the
   end; its streams must equal a 1-stage engine's. Then a fused int8-KV
   engine serves the same requests. Each path's kernel launches are
   counted from 0 and must all be > 0. Where an int8 stream leaves the
   bf16 one, the logits at its first diverging token are taken from one
   prefill of the shared context with bf16 pages, with int8 pages, and
   with each page dtype through the plain ragged version: the bf16 top-2
   margin there must be within how far int8 pages move the logits, and
   the int8 kernel's logits must stray from its plain version's no more
   than twice as far as the bf16 kernel's from its own. In the 1-stage and int8 runs, four
   decode steps run under ``torch.profiler`` (device time per step, the
   kernels that take it) and are left out of the step timings. Every
   ragged and paged decode launch of the main and int8 paths must have
   taken the tensor-core body (``ops.body_counts``). Last, one forward of
   the
   412-token prompt through ``Model.prefill`` on each layout (flash;
   ragged over bf16 and over int8 pages) under ``torch.profiler``: the
   forward's device ms and the attention kernel's share (``PREFILL``).
4. cold start, the main path of the slot-contiguous layout: a
   ``ServerlessFrontend`` over 4 servers deploys full-width, full-depth
   granite-3-8b (random bf16 weights from a seeded generator) into the
   memory tier, cold-starts it to 2 stages (Alg. 1, streamed stage loads
   out of the store, ``paged=False``), serves the same 4 requests and
   consolidates through ``full_params`` after 4 tokens. Its streams must
   equal a 1-stage contiguous engine's on the same weights; its launches
   must show flash and contiguous decode > 0 and both paged kernels at 0,
   and every flash and contiguous decode launch on the tensor-core body.
   Printed: the Alg. 1 scheme, the cold-start timeline (simulated clock),
   the measured wall time and GB/s of each stage's ``materialize()`` and of
   ``full_params`` (host -> card), serve rates, a profiled window, and the
   share of tokens on which the contiguous streams agree with a paged
   engine's. Where they part, the logits at the first diverging token
   from one prefill of the shared context on each layout: the contiguous
   top-2 margin there beside how far the layout moves the logits
   (reported, not asserted).
5. rwkv cold start, the path of the WKV6 kernel: the same frontend deploys
   full-width, full-depth rwkv6-1.6b (24 layers, d 2048, 32 heads of 64,
   d_ff 7168, vocab 65536, random bf16 weights from a seeded generator),
   cold-starts it to 2 slot-contiguous stages, serves the same 4 requests
   and consolidates through ``full_params`` after 4 tokens. Its streams must
   equal a 1-stage contiguous engine's and a 1-stage paged engine's on the
   same weights, exactly (an attention-free model runs the same kernels in
   the same order on either layout); its launches must show ``wkv6`` > 0
   and every attention kernel at 0, and ``wkv6`` launched once a layer for
   each prompt's prefill and each decode step. Printed as for phase 4,
   with a profiled window of the 1-stage contiguous engine; first, far
   from that window, one 412-token ``Model.prefill`` under
   ``torch.profiler``: its device ms and wkv6's share (``RWKV_PREFILL``).
6. disk tier: full width, depth cut to 4 layers. A store written by
   ``deploy(..., store_dir=...)`` (inside the checkout, deleted after) is
   cold-deployed (``params=None``) by a second frontend, which must serve
   the memory tier's streams on the same weights.
7. KV tiers, routing and the sanitizer (``TIER``): full-width, full-depth
   granite-3-8b (bf16, paged, block 16, random weights from a seeded
   generator) on two replicas of ``max_batch`` 2 and ``max_seq`` 512 (66
   blocks each) that share one ``KVBlockStore`` (24 host blocks, then the
   segment tier) and one ``Router("kv_affinity")``; replica A runs the
   KV-lifecycle sanitizer (strict) and dispatch's kernel contract checks,
   B neither. Prompts of 300 tokens: two served twice (the second a warm
   prefix hit), six more churn A's pool so that evictions spill and
   demote, the first is served again on A (restored from the tiers), the
   second and the churn prompt with the most host-tier blocks go through
   the router to B (restored from both tiers). Restored streams must equal
   the warm ones exactly, the same prompt on A and on B must give the same
   stream, every block spilled or restored must move 2,621,440 B, the
   sanitizer must find nothing, and every ragged and paged decode launch
   must take the tensor-core body. A fused int8 replica with its own tier
   repeats the first three steps (1,392,640 B a block). Reported: cold vs
   warm streams, the wall GB/s of ``read_pages`` and ``write_pages`` of 16
   blocks, the decode-step p50 of A and B (the sanitizer's and the checks'
   cost) and each check's cost a call, the router's decisions.
8. the fleet (``FLEET``): one ``FleetFrontend`` on the card over the
   4 servers of phase 4 (source tier at the remote registry's 2 Gbps,
   placements at the peer's 16 Gbps; ``FleetPolicy(keepalive_s=30,
   proactive_placement=True, placement_interval_s=10, placement_top_k=2)``)
   serves granite-3-8b (routed ``kv_affinity``, a 64-block KV host tier,
   paged, prefix cache, block 16, 2-stage cold starts) and rwkv6-1.6b
   (slot-contiguous), both full width and depth, bf16, each registered
   once into a host-memory store from its seeded weights. On the simulated
   clock: granite P1 (300 tokens) and P2 (257) and rwkv R1 (412) at t=0,
   both cold starts contending; P1 again at granite's ready + 5 s (a prefix
   hit); past the keepalive (placement rounds, idle consolidation through
   ``full_params``, the reap, which spills granite's prefix cache to the
   host tier); P1 and R1 again, cold, then drained to zero. Held: the
   first streams equal 1-stage engines' on the same weights (paged granite,
   contiguous rwkv); the re-warmed R1 equals the first; the re-warmed P1
   (its prefix restored from the host tier) equals the warm one, both
   prefix-cached (cold against prefix-cached P1 is reported, with the
   logits where they part, as phase 7 reports cold against warm); 4 cold
   starts, the
   second pair from the placed ``peer`` tier and granite's second shorter;
   a consolidation; host blocks after the reap and restored tokens on the
   second P1; every slot empty and the card's allocated memory back within
   256 MiB after the drain; ragged, paged decode and wkv6 launched, the
   attention kernels on the tensor cores. Reported: the wall GB/s of every
   ``materialize()`` and ``full_params``, the fleet's metrics and cold
   starts (simulated), the peak allocated memory.
9. sparse experts and Mamba (``FAMILIES``, ``G1``): see ``families_phase``.
10. the encoder-decoder and image prefixes (``ENCDEC_VLM``): the four
   attention kernels at whisper-small's shapes (hd 64, group 1: the
   non-causal encoder over 1,500 frames, cross-attention of a chunk and
   of one row over them, the decoder's prefill and contiguous decode) and
   llava-next-34b's (group 7: the 988-row prefix prefill, both decode
   kernels, the ragged kernel over bf16 and int8 pages), held against
   their plain versions and timed (``ENCDEC_VLM_KERNELS``); whisper-small
   at full width and depth through ``Model.prefill(frames=...)`` and 31
   decode steps at batch 4, its logits held to one full decoder forward;
   llava-next-34b at full width and depth (64.05 GiB) through paged and
   contiguous endpoints, 2-stage consolidated == 1-stage on each, with
   three 576-row image prefixes and one text-only request, and fused
   engines that refuse a prefix before admitting it; then each example
   twin of ``repro_torch.examples`` once on the card.
11. training (``TRAIN``): granite-3-8b at full width, depth cut to 8 of
   its 40 layers (all 40 need about 100 GB for bf16 params and gradients
   and two float32 moments), bf16, on the production per-chip train shape
   (one sequence of 4,096 from ``SyntheticTokens``). One step's loss and
   gradients through the flash kernel (``ops._FlashFn``: the kernel
   forward, the plain version's autodiff backward) against a forward on
   the plain version: loss within 1e-2 relative, gradient norm within
   3e-2, each leaf's cosine at least 0.99. Then six steps of
   ``make_train_step(remat="full", grad_dtype="bfloat16")`` on the one
   batch: finite losses, step 6's below 0.8 of step 1's, flash launched
   16 times a step (forward and recompute) on the tensor cores with 8
   plain backwards and no other kernel. Printed beside the card's name and
   power limit: step ms (p50 of steps 2-6), tokens/s, ``train_mfu`` (3 x
   ``roofline/analytic.py``'s forward FLOPs over the step time over 989
   TFLOP/s), one profiled step's busy share and the shares of its device
   time taken by the flash forward, the plain backwards and
   ``apply_updates``, the peak allocated memory beside the resident bytes
   reckoned from the defs; the same steps at a peak lr of 1e-3 (reported);
   the ``train_small`` twin with a resume.
12. the distributed prefills (``DIST``): the flash kernel alone at every
   shape the phase launches it at (B 2, 32,768 rows, causal, hd 128: the
   forward's 32 q over 8 kv heads, the manual-TP prefill's 32 q heads over
   the 32 kv heads each selects, a tp = 16 rank's 2; B 1, 32,768: a
   pipeline micro-batch's 32 over 8; B 1, 8,192: a tp = 2 rank's 16 at
   group 1), each held row by row against its float32 plain version on
   two or three (batch row, q head) pairs and timed beside its bound, that
   plain version on one pair and one SDPA call (``DIST_KERNELS``); then
   granite-3-8b at full width and depth (bf16, 15.60 GiB) in the manual-TP
   prefill at tp 2 on B 1 x 8,192, as two processes on this card over
   gloo (NCCL refuses two ranks on one GPU), each rank's vocab columns
   and K/V slice held against its own one-rank forward and its flash
   launches counted from 0; then on tokens of B
   2 x 32,768 (``prefill_32k``'s share of one of 16 data ranks) on a
   one-rank NCCL process group: the reference forward
   (``Model.prefill(paged=False)``), the manual-TP prefill at tp 1 and the
   pipelined prefill at 1 stage with 2 micro-batches, each run's launches
   counted from 0 (flash 40, 40 and 80, every one on the tensor cores,
   no other kernel); each run's last-token logits within 2^-5 of the
   forward's largest |logit| and each manual-TP K/V layer within 2^-7 of
   the forward's layer's largest |value| plus 1e-4; argmax agreement
   reported; each run's device ms, wall ms and peak allocated bytes.

13. the reference's modes (``APPEND_SKIP``): one decode step of the
   ``append`` mode at full width (B 4, 32 q over 8 kv heads of 128, bf16
   strips of 1,024 rows, kv_len 316/273/428/206): the softmax stats of
   ``decode_attention_with_stats`` (plain torch on the card) against
   float32 sums (1e-5 of the largest), their normalised output and the
   merged new token against the contiguous decode kernel (each row within
   2^-6 of its largest |value| plus 2e-4: two bf16 outputs, each within one
   row limit of the float32 sum) and the merge against the float32 plain
   decode (one row limit); the stats, the append step and the kernel
   timed. The float32 bodies at the float32 serves' shapes, to 1e-5 of
   their float32 plain versions: flash under causal_skip at batch 1, Sq =
   Sk = each prompt (190, 257, 300, 412), 32 q over 8 kv heads of 128;
   the contiguous decode kernel and the append merge at B 4 over 1,024-row
   strips. Then granite-3-8b at full width and depth (as phase 4) through
   ``Engine(paged=False)`` under scatter and under append x causal_skip,
   in bf16 and with the same weights in float32, each serve's launches
   counted from 0: flash under both modes (the kernel, not a blocked plain
   version), the decode kernel under scatter only, bf16 launches on the
   tensor cores; float32 streams equal token for token. Each serve's own
   decode logits are kept (each row's argmax held to the token emitted):
   at every step the streams share, the modes' logit shift within 2^-5 of
   the row's largest |logit|; where the bf16 streams part, the two
   tokens' scatter logits within that step's shift; the top-2 margins,
   shifts and parting logits reported. Printed: each serve's flash
   launches, device-clock ms between CUDA events and profiled device ms a
   decode step.

Every phase is timed with CUDA events around it and on the wall clock
(``PHASES``, a line before the result).

Any failed check raises, and the script exits nonzero without a result
line. On success the second-to-last line is the ``kernels`` JSON (every
ported kernel; ``not_ported`` is empty now that every TPU kernel has its
counterpart) and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's peaks, HBM_BYTES_PER_S, BF16_FLOPS and F32_FLOPS (H100 SXM data
# sheet), come from the port's ``roofline/analysis.py``: ``main`` binds them
# here once ``src`` is on the path.

Hq, HKV, HD, BS = 32, 8, 128, 16  # granite-3-8b attention at full width
PROFILE_AT = 16                   # a decode step of the serve phase
MAX_NEW = 32                      # tokens each request generates


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


HOLD_CYCLES = 2_000_000   # ~1 ms of the card spinning: covers a wrapper's
                          # host-side checks and launch


def time_ms(torch, fn, reps=20, warmup=3, flush=None, hold=True):
    """Median of ``reps`` CUDA-event timings of ``fn()``, L2 flushed before
    each (``flush`` is a >50 MB buffer the flush overwrites). With ``hold``
    the card spins (``torch.cuda._sleep``) after the flush while the host
    enqueues the start event and ``fn``'s launches, so a kernel shorter than
    its wrapper's host-side work is timed alone, not with the card idling
    until the launch arrives; work whose host side outlasts the spin (the
    plain versions' many small launches) still counts its host time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_ms(torch, fn, reps, flush):
    """A kernel's time with the card held through the enqueue (``ms``),
    and without the hold, the card idle until the launch arrives
    (``ms_host_gap``: the wrapper's host-side work included)."""
    return {"ms": time_ms(torch, fn, reps, flush=flush),
            "ms_host_gap": time_ms(torch, fn, reps, flush=flush, hold=False)}


def bound_ms(n_bytes, flops, peak):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels at the main path's shapes
# ---------------------------------------------------------------------------


# (history rows, new tokens) per request: the kernel phase's mixed batch
# (two prefill chunks with history, four decode rows), and a fused decode
# step of the same four decode rows alone
MIXED_SPECS = [(300, 256), (100, 203), (1023, 1), (776, 1), (299, 1), (0, 1)]
DECODE_SPECS = [(1023, 1), (776, 1), (299, 1), (0, 1)]


def ragged_batch(torch, hq, hkv, hd, bs, dtype, seed, specs=MIXED_SPECS):
    """A ragged batch in the runner's layout, one request per spec, then one
    pad tile; each request's pages at scattered ids. Returns (q, k, v,
    tables, row, pos)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = max(-(-(h + n) // bs) for h, n in specs)
    n_pages = len(specs) * nb + 1                          # + trash page
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")
    tables = perm.reshape(len(specs), nb).to(torch.int32)
    rows, poss = [], []
    for r, (h, n) in enumerate(specs):
        na = -(-n // 8) * 8
        rows += [r] * na
        poss += list(range(h, h + n)) + [-1] * (na - n)
    rows += [0] * 8                                        # a pad tile
    poss += [-1] * 8
    t = len(rows)
    k = torch.randn((n_pages, bs, hkv, hd), generator=g, device="cuda")
    v = torch.randn((n_pages, bs, hkv, hd), generator=g, device="cuda")
    q = torch.randn((t, hq, hd), generator=g, device="cuda")
    row = torch.tensor(rows, dtype=torch.int32, device="cuda")
    pos = torch.tensor(poss, dtype=torch.int32, device="cuda")
    return q.to(dtype), k, v, tables, row, pos


def ragged_cost(q, pages_bytes_per_row, tables, row, pos, hkv, hd):
    """Bytes the function must move (q, the K/V rows its tokens need, each
    once, the output) and its operations (QK and PV)."""
    t, hq, _ = q.shape
    need = {}
    for r, p in zip(row.tolist(), pos.tolist()):
        if p >= 0:
            need[r] = max(need.get(r, 0), p + 1)
    kv_rows = sum(need.values())
    n_bytes = (2 * q.numel() * q.element_size()
               + kv_rows * pages_bytes_per_row
               + (tables.numel() + row.numel() + pos.numel()) * 4)
    flops = sum(4 * hq * hd * (p + 1) for p in pos.tolist() if p >= 0)
    return n_bytes, flops


def sdpa_ragged(torch, q, k, v, tables, row, pos):
    """The library yardstick: one SDPA call over the whole pool with a
    boolean mask built from the tables (the mask and layouts are made
    before timing). Returns a zero-argument callable."""
    import torch.nn.functional as F
    n_pages, bs, hkv, hd = k.shape
    t, hq, _ = q.shape
    kpos = torch.arange(n_pages * bs, device="cuda")
    # key index -> (page, slot); page -> (table row, block) inverse map
    inv_row = torch.full((n_pages,), -1, dtype=torch.long, device="cuda")
    inv_blk = torch.full((n_pages,), -1, dtype=torch.long, device="cuda")
    nb = tables.shape[1]
    inv_row[tables.long().flatten()] = torch.arange(
        tables.shape[0], device="cuda").repeat_interleave(nb)
    inv_blk[tables.long().flatten()] = torch.arange(
        nb, device="cuda").repeat(tables.shape[0])
    key_row = inv_row[kpos // bs]
    key_pos = inv_blk[kpos // bs] * bs + kpos % bs
    mask = ((key_row[None, :] == row.long()[:, None])
            & (key_pos[None, :] <= pos.long()[:, None]))
    qq = q.permute(1, 0, 2)[None]
    kk = k.reshape(-1, hkv, hd).permute(1, 0, 2)[None].to(q.dtype)
    vv = v.reshape(-1, hkv, hd).permute(1, 0, 2)[None].to(q.dtype)
    rep = hq // hkv
    kk = kk.repeat_interleave(rep, dim=1).contiguous()
    vv = vv.repeat_interleave(rep, dim=1).contiguous()
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)


def sdpa_decode(torch, q, k, v, tables, kv_len):
    import torch.nn.functional as F
    n_pages, bs, hkv, hd = k.shape
    b, _, hq, _ = q.shape
    nb = tables.shape[1]
    idx = (tables.long()[:, :, None] * bs
           + torch.arange(bs, device="cuda")).reshape(b, nb * bs)
    kk = k.reshape(-1, hkv, hd)[idx].permute(0, 2, 1, 3)   # (B,Hkv,L,hd)
    vv = v.reshape(-1, hkv, hd)[idx].permute(0, 2, 1, 3)
    rep = hq // hkv
    kk = kk.repeat_interleave(rep, dim=1).contiguous()
    vv = vv.repeat_interleave(rep, dim=1).contiguous()
    mask = (torch.arange(nb * bs, device="cuda")[None, :]
            < kv_len.long()[:, None])[:, None, None, :]
    qq = q.permute(0, 2, 1, 3)                              # (B,Hq,1,hd)
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)


def check(name, got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    log(f"  {name}: max abs err {err:.3e} (tol {tol})")
    return err


ROW_REL = 2.0 ** -7   # twice the most one bf16 rounding moves a value
ROW_ATOL = 1e-4       # float32 sums over <= 1,024 keys in another order


def check_rows(name, got, want):
    """A bf16 output against its float32 plain version, row by row: each
    output row's (token, head) worst error must stay within ROW_REL of
    the row's largest |want| plus ROW_ATOL, so a long row with small
    outputs is held as tightly as a short one. Returns (max abs err,
    worst error over its row's limit)."""
    d = (got.float() - want.float()).abs().amax(-1)
    lim = ROW_REL * want.float().abs().amax(-1) + ROW_ATOL
    err, ratio = float(d.max()), float((d / lim).max())
    if not math.isfinite(ratio) or ratio > 1:
        raise AssertionError(f"{name}: a row's error is {ratio:.3f} of its "
                             f"limit (max abs err {err:.3e})")
    log(f"  {name}: max abs err {err:.3e}, worst row at {ratio:.3f} of its "
        f"limit ({ROW_REL:.4g}*max|row| + {ROW_ATOL})")
    return err, ratio


def sdpa_flash(torch, q, k, v, causal=True):
    """One SDPA call (causal unless told) on (B,H,S,hd) layouts with K/V
    heads repeated to Hq (made before timing)."""
    import torch.nn.functional as F
    rep = q.shape[2] // k.shape[2]
    qq = q.transpose(1, 2).contiguous()
    kk = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vv = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                  is_causal=causal)


FLASH_STATS = ("tile_rows", "tflops")   # flash_stats' keys
RAGGED_STATS = ("body", "tile_rows")    # ragged_stats' keys
DECODE_STATS = ("cluster", "partials")  # decode_stats' keys


def ragged_stats(torch, launch):
    """The body and the span kernel's tile (query rows a block) that the
    ragged kernel took on one call of ``launch``, as the C entry point
    reports them (``BODY_LAUNCHES``, ``TILE_LAUNCHES``; tile 0: the
    CUDA-core body)."""
    from repro_torch.kernels import ragged_attention as kra
    bodies, tiles = dict(kra.BODY_LAUNCHES), dict(kra.TILE_LAUNCHES)
    launch()
    body = [k.split("/")[1] for k, n in kra.BODY_LAUNCHES.items()
            if n != bodies[k]]
    took = [t for t, n in kra.TILE_LAUNCHES.items() if n != tiles[t]]
    if len(body) != 1 or len(took) > 1:
        raise RuntimeError(f"ragged: one launch moved bodies {body}, "
                           f"tiles {took}")
    return {"body": body[0], "tile_rows": took[0] if took else 0}


def decode_stats(torch, name, launch):
    """The cluster size (blocks a sequence and kv head) that one call of
    ``launch`` of decode kernel ``name`` took on its tensor-core body, as
    the C entry point reports it, and where its partials went (the f32
    workspace: ``LAST_LAUNCH``)."""
    from repro_torch.kernels import decode_attention as kda
    kda.LAST_LAUNCH[name] = None
    launch()
    last = kda.LAST_LAUNCH[name]
    if last is None:
        raise RuntimeError(f"{name}: no tensor-core launch reported")
    return dict(last)


def ragged_line(label, r):
    """One ragged timing line: ms, bound, and what the launch reported."""
    return (f"  {label}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; {r['body']} body, span tile {r['tile_rows']} "
            f"rows; plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}"
            f", host gap {r['ms_host_gap']:.4f} ms)")


def flash_stats(torch, launch, flops, ms):
    """The tile (query rows a block) that the flash kernel's tensor-core
    body took on one call of ``launch``, as the C entry point reports it
    (``TILE_LAUNCHES``), and the TFLOP/s of ``flops`` in ``ms``."""
    from repro_torch.kernels import flash_attention as kfa
    before = dict(kfa.TILE_LAUNCHES)
    launch()
    took = [t for t, n in kfa.TILE_LAUNCHES.items() if n != before[t]]
    if len(took) != 1:
        raise RuntimeError(f"flash: one launch moved tile counts {took}")
    return {"tile_rows": took[0], "tflops": flops / ms / 1e9}


def sdpa_contig_decode(torch, q, k, v, kv_len):
    import torch.nn.functional as F
    rep = q.shape[2] // k.shape[2]
    kk = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    vv = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(k.shape[1], device="cuda")[None, :]
            < kv_len.long()[:, None])[:, None, None, :]
    qq = q.transpose(1, 2).contiguous()                     # (B,Hq,1,hd)
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)


def kernel_phase(torch, quick):
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ragged_attention as kra
    from repro_torch.kernels import ref

    reps = 5 if quick else 20
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {}

    # -- ragged, f32 at hd 16 (the smoke width), TF32 off: tight check
    q, k, v, tb, row, pos = ragged_batch(torch, 4, 2, 16, 4, torch.float32, 1)
    check("ragged f32 hd16",
          kra.ragged_paged_attention(q, k, v, tb, row, pos),
          ref.ragged_paged_attention_reference(q, k, v, tb, row, pos), 1e-5)

    # -- ragged at the main path's shapes
    q, k32, v32, tb, row, pos = ragged_batch(torch, Hq, HKV, HD, BS,
                                             torch.bfloat16, 2)
    live = pos >= 0
    q32 = q.float()
    out = {}
    for label, kd in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
        k, v = k32.to(kd), v32.to(kd)
        got = kra.ragged_paged_attention(q, k, v, tb, row, pos)
        want = ref.ragged_paged_attention_reference(q32, k.float(),
                                                    v.float(), tb, row, pos)
        err = check_rows(f"ragged {label} pages", got, want)
        if not bool((got[~live] == 0).all()):
            raise AssertionError("ragged: pad rows are not exactly 0")
        out[label] = (k, v, err)
    kq, ks, kz = ref.quantize_kv(k32)
    vq, vs, vz = ref.quantize_kv(v32)
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    got = kra.ragged_paged_attention(q, kq, vq, tb, row, pos, kv_quant=quant)
    want = ref.ragged_paged_attention_reference(q32, kq, vq, tb, row, pos,
                                                kv_quant=quant)
    err_q8 = check_rows("ragged int8 pages", got, want)

    k, v, err = out["bf16"]
    nbytes, flops = ragged_cost(q, 2 * HKV * HD * 2, tb, row, pos, HKV, HD)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    rows["ragged_paged_attention"] = dict(
        **kernel_ms(torch, lambda: kra.ragged_paged_attention(
            q, k, v, tb, row, pos), reps, flush),
        plain_ms=time_ms(torch, lambda: ref.ragged_paged_attention_reference(
            q, k, v, tb, row, pos), max(3, reps // 4), 1, flush),
        library_ms=time_ms(torch, sdpa_ragged(torch, q, k, v, tb, row, pos),
                           reps, flush=flush),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
        err_over_tol=err[1])
    rows["ragged_paged_attention"].update(ragged_stats(
        torch, lambda: kra.ragged_paged_attention(q, k, v, tb, row, pos)))
    log(ragged_line("ragged mixed batch, bf16 pages",
                    rows["ragged_paged_attention"]))
    nbytes, flops = ragged_cost(q, 2 * HKV * (HD + 4 * 2), tb, row, pos,
                                HKV, HD)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    kdq = ref.dequantize_kv(kq, ks, kz).to(torch.bfloat16)
    vdq = ref.dequantize_kv(vq, vs, vz).to(torch.bfloat16)
    rows["ragged_paged_attention_q8"] = dict(
        **kernel_ms(torch, lambda: kra.ragged_paged_attention(
            q, kq, vq, tb, row, pos, kv_quant=quant), reps, flush),
        plain_ms=time_ms(torch, lambda: ref.ragged_paged_attention_reference(
            q, kq, vq, tb, row, pos, kv_quant=quant), max(3, reps // 4), 1,
            flush),
        library_ms=time_ms(torch, sdpa_ragged(torch, q, kdq, vdq, tb, row,
                                              pos), reps, flush=flush),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err_q8[0],
        err_over_tol=err_q8[1])
    rows["ragged_paged_attention_q8"].update(ragged_stats(
        torch, lambda: kra.ragged_paged_attention(q, kq, vq, tb, row, pos,
                                                  kv_quant=quant)))
    log(ragged_line("ragged mixed batch, int8 pages",
                    rows["ragged_paged_attention_q8"]))

    # -- ragged at a fused decode-only step: the four decode rows alone (the
    # shape of most of the int8 engine's launches: 4 tiles x 8 kv heads =
    # 32 blocks), bf16 and int8 pages; printed, not in the kernels line
    q, k32, v32, tb, row, pos = ragged_batch(torch, Hq, HKV, HD, BS,
                                             torch.bfloat16, 5, DECODE_SPECS)
    kq, ks, kz = ref.quantize_kv(k32)
    vq, vs, vz = ref.quantize_kv(v32)
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    kdq = ref.dequantize_kv(kq, ks, kz).to(torch.bfloat16)
    vdq = ref.dequantize_kv(vq, vs, vz).to(torch.bfloat16)
    decode_rows = {}
    for label, k, v, kvq, row_bytes, lk, lv in (
            ("bf16", k32.bfloat16(), v32.bfloat16(), None, 2 * HKV * HD * 2,
             k32.bfloat16(), v32.bfloat16()),
            ("int8", kq, vq, quant, 2 * HKV * (HD + 4 * 2), kdq, vdq)):
        got = kra.ragged_paged_attention(q, k, v, tb, row, pos, kv_quant=kvq)
        want = ref.ragged_paged_attention_reference(
            q.float(), k if kvq else k.float(), v if kvq else v.float(), tb,
            row, pos, kv_quant=kvq)
        err = check_rows(f"ragged decode-only step, {label} pages", got,
                         want)
        if not bool((got[pos < 0] == 0).all()):
            raise AssertionError("ragged decode-only: pad rows are not 0")
        if kvq is None:
            # the decode rows through the paged decode kernel: its split
            # body and combine, so the same bits
            first = torch.nonzero(pos >= 0).flatten()
            paged = kda.paged_decode_attention(
                q[first][:, None].contiguous(), k, v, tb,
                (pos[first] + 1).to(torch.int32))
            if not torch.equal(got[first], paged[:, 0]):
                raise AssertionError("ragged decode-only step, bf16 pages: "
                                     "not the paged decode kernel's bits")
            log("  ragged decode-only step, bf16 pages: equal to the paged "
                "decode kernel's output bit for bit")
        nbytes, flops = ragged_cost(q, row_bytes, tb, row, pos, HKV, HD)
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        decode_rows[label] = dict(
            **kernel_ms(torch, lambda: kra.ragged_paged_attention(
                q, k, v, tb, row, pos, kv_quant=kvq), reps, flush),
            plain_ms=time_ms(torch, lambda: ref.ragged_paged_attention_reference(
                q, k, v, tb, row, pos, kv_quant=kvq), max(3, reps // 4), 1,
                flush),
            library_ms=time_ms(torch, sdpa_ragged(torch, q, lk, lv, tb, row,
                                                  pos), reps, flush=flush),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
            err_over_tol=err[1])
        decode_rows[label].update(ragged_stats(
            torch, lambda: kra.ragged_paged_attention(q, k, v, tb, row, pos,
                                                      kv_quant=kvq)))
        log(ragged_line(f"ragged decode-only step ({label} pages, kv_len "
                        f"1024/777/300/1)", decode_rows[label]))
    log("RAGGED_DECODE " + json.dumps(decode_rows))

    # -- paged decode, f32 at hd 16, TF32 off
    g = torch.Generator(device="cuda").manual_seed(3)

    def decode_inputs(hq, hkv, hd, bs, lens, dtype):
        b = len(lens)
        nb = -(-max(lens) // bs) + 1
        n_pages = b * nb + 1
        tables = torch.randperm(n_pages - 1, generator=g, device="cuda")[
            :b * nb].reshape(b, nb).to(torch.int32)
        kk = torch.randn((n_pages, bs, hkv, hd), generator=g, device="cuda")
        vv = torch.randn((n_pages, bs, hkv, hd), generator=g, device="cuda")
        qq = torch.randn((b, 1, hq, hd), generator=g, device="cuda")
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        return qq.to(dtype), kk.to(dtype), vv.to(dtype), tables, kl

    qd, kd_, vd, tbd, kl = decode_inputs(4, 2, 16, 4, [37, 1, 0, 16],
                                         torch.float32)
    check("decode f32 hd16",
          kda.paged_decode_attention(qd, kd_, vd, tbd, kl),
          ref.paged_decode_attention_reference(qd, kd_, vd, tbd, kl), 1e-5)
    lens = [1024, 777, 300, 1]
    qd, kd_, vd, tbd, kl = decode_inputs(Hq, HKV, HD, BS, lens,
                                         torch.bfloat16)
    err = check_rows("decode bf16 pages",
                     kda.paged_decode_attention(qd, kd_, vd, tbd, kl),
                     ref.paged_decode_attention_reference(
                         qd.float(), kd_.float(), vd.float(), tbd, kl))
    nbytes = (sum(lens) * 2 * HKV * HD * 2 + 2 * qd.numel() * 2
              + (tbd.numel() + kl.numel()) * 4)
    flops = sum(4 * Hq * HD * n for n in lens)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    rows["paged_decode_attention"] = dict(
        **kernel_ms(torch, lambda: kda.paged_decode_attention(
            qd, kd_, vd, tbd, kl), reps, flush),
        plain_ms=time_ms(torch, lambda: ref.paged_decode_attention_reference(
            qd, kd_, vd, tbd, kl), reps, flush=flush),
        library_ms=time_ms(torch, sdpa_decode(torch, qd, kd_, vd, tbd, kl),
                           reps, flush=flush),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
        err_over_tol=err[1])
    rows["paged_decode_attention"].update(decode_stats(
        torch, "paged_decode_attention",
        lambda: kda.paged_decode_attention(qd, kd_, vd, tbd, kl)))
    log(f"  paged decode (kv_len 1024/777/300/1): "
        f"{rows['paged_decode_attention']}")

    # -- flash attention over contiguous K/V: f32 at hd 16 (TF32 off), then
    # the main path's prefills (batch 1, causal, Sq = Sk = a prompt)
    g4 = torch.Generator(device="cuda").manual_seed(4)

    def qkv(b, sq, sk, hq, hkv, hd, dtype):
        return [torch.randn((b, n, h, hd), generator=g4, device="cuda")
                .to(dtype) for n, h in ((sq, hq), (sk, hkv), (sk, hkv))]

    q, k, v = qkv(2, 45, 45, 4, 2, 16, torch.float32)
    check("flash f32 hd16 causal", kfa.flash_attention(q, k, v),
          ref.mha_reference(q, k, v), 1e-5)
    q, k, v = qkv(1, 20, 37, 4, 2, 16, torch.float32)
    check("flash f32 hd16 causal q_offset 17",
          kfa.flash_attention(q, k, v, q_offset=17),
          ref.mha_reference(q, k, v, q_offset=17), 1e-5)
    check("flash f32 hd16 non-causal",
          kfa.flash_attention(q, k, v, causal=False),
          ref.mha_reference(q, k, v, causal=False), 1e-5)
    flash = {}
    for sq in (300, 412):
        q, k, v = qkv(1, sq, sq, Hq, HKV, HD, torch.bfloat16)
        err = check_rows(f"flash bf16 Sq=Sk={sq}",
                         kfa.flash_attention(q, k, v),
                         ref.mha_reference(q.float(), k.float(), v.float()))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * Hq * HD * sq * (sq + 1) // 2
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        flash[sq] = dict(
            **kernel_ms(torch, lambda: kfa.flash_attention(q, k, v), reps,
                        flush),
            plain_ms=time_ms(torch, lambda: ref.mha_reference(q, k, v),
                             reps, flush=flush),
            library_ms=time_ms(torch, sdpa_flash(torch, q, k, v), reps,
                               flush=flush),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
            err_over_tol=err[1])
        flash[sq].update(flash_stats(
            torch, lambda: kfa.flash_attention(q, k, v), flops,
            flash[sq]["ms"]))
        log(f"  flash Sq=Sk={sq}: {flash[sq]}")
    rows["flash_attention"] = flash[412]

    # -- decode over contiguous caches: f32 at hd 16, then batch 4 at S 1024
    def contig(hq, hkv, hd, s, lens, dtype):
        qq, kk, vv = qkv(len(lens), 1, s, hq, hkv, hd, dtype)
        return qq, kk, vv, torch.tensor(lens, dtype=torch.int32,
                                        device="cuda")

    qd, kc, vc, kl = contig(4, 2, 16, 64, [37, 1, 0, 64], torch.float32)
    check("decode (contiguous) f32 hd16",
          kda.decode_attention(qd, kc, vc, kl),
          ref.decode_attention_reference(qd, kc, vc, kl), 1e-5)
    lens = [1024, 777, 300, 1]
    qd, kc, vc, kl = contig(Hq, HKV, HD, 1024, lens, torch.bfloat16)
    err = check_rows("decode (contiguous) bf16 caches",
                     kda.decode_attention(qd, kc, vc, kl),
                     ref.decode_attention_reference(
                         qd.float(), kc.float(), vc.float(), kl))
    empty = kda.decode_attention(qd[:1].contiguous(), kc[:1].contiguous(),
                                 vc[:1].contiguous(),
                                 torch.zeros(1, dtype=torch.int32,
                                             device="cuda"))
    torch.cuda.synchronize()
    if not bool((empty == 0).all()):
        raise AssertionError("decode (contiguous): a kv_len 0 row is not 0")
    log("  decode (contiguous) kv_len 0 row: exactly 0")
    nbytes = (sum(lens) * 2 * HKV * HD * 2 + 2 * qd.numel() * 2
              + kl.numel() * 4)
    flops = sum(4 * Hq * HD * n for n in lens)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    rows["decode_attention"] = dict(
        **kernel_ms(torch, lambda: kda.decode_attention(qd, kc, vc, kl),
                    reps, flush),
        plain_ms=time_ms(torch, lambda: ref.decode_attention_reference(
            qd, kc, vc, kl), reps, flush=flush),
        library_ms=time_ms(torch, sdpa_contig_decode(torch, qd, kc, vc, kl),
                           reps, flush=flush),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
        err_over_tol=err[1])
    rows["decode_attention"].update(decode_stats(
        torch, "decode_attention",
        lambda: kda.decode_attention(qd, kc, vc, kl)))
    log(f"  contiguous decode (kv_len 1024/777/300/1, S 1024): "
        f"{rows['decode_attention']}")

    decode_shape_phase(torch, reps, flush)

    rows["wkv6"] = wkv6_checks(torch, reps, flush)

    for name, r in rows.items():
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else "none: no one PyTorch call computes it")
        log(f"  {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {lib}; "
            f"timed without the hold, the card idle until the launch: "
            f"{r['ms_host_gap']:.4f} ms)")
    return rows


# the engine's decode step at PROFILE_AT: the serve's four prompts (300,
# 257, 412, 190 tokens) 16 tokens in, under the runner's block table
# (max_seq 1024 // page 16 + 1 pages a row) or its 1024-row cache strips;
# and the kernel phase's main shapes under the same table and strips
DECODE_SHAPES = {"engine": [316, 273, 428, 206], "main": [1024, 777, 300, 1]}
ENGINE_TABLE = 1024 // BS + 1
ENGINE_S = 1024


def decode_shape_phase(torch, reps, flush):
    """Both decode kernels (bf16, Hq 32, Hkv 8, hd 128) at the engine's own
    decode step and at the main shapes, under the engine's table width and
    cache S: each held row by row against its float32 plain version and
    timed beside one SDPA call and its bound. Printed as ``DECODE``.
    Needs only the two wrappers, so it runs on earlier trees too
    (``--decode-shape``), for a before and after from one card."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    out = {}
    for shape, lens in DECODE_SHAPES.items():
        b = len(lens)
        n_pages = b * ENGINE_TABLE + 1
        tables = torch.randperm(n_pages - 1, generator=g,
                                device="cuda").reshape(
            b, ENGINE_TABLE).to(torch.int32)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = randn(b, 1, Hq, HD)
        kp, vp = randn(n_pages, BS, HKV, HD), randn(n_pages, BS, HKV, HD)
        kc, vc = randn(b, ENGINE_S, HKV, HD), randn(b, ENGINE_S, HKV, HD)
        nbytes = sum(lens) * 2 * HKV * HD * 2 + 2 * q.numel() * 2 + b * 4
        flops = sum(4 * Hq * HD * n for n in lens)
        res = {}
        for name, fn, plain, lib, table_bytes in (
                ("paged_decode_attention",
                 lambda: kda.paged_decode_attention(q, kp, vp, tables, kl),
                 lambda: ref.paged_decode_attention_reference(
                     q.float(), kp.float(), vp.float(), tables, kl),
                 sdpa_decode(torch, q, kp, vp, tables, kl),
                 tables.numel() * 4),
                ("decode_attention",
                 lambda: kda.decode_attention(q, kc, vc, kl),
                 lambda: ref.decode_attention_reference(
                     q.float(), kc.float(), vc.float(), kl),
                 sdpa_contig_decode(torch, q, kc, vc, kl), 0)):
            err = check_rows(f"{name} at the {shape} decode shape", fn(),
                             plain())
            b_ms, b_by = bound_ms(nbytes + table_bytes, flops, BF16_FLOPS)
            res[name] = dict(**kernel_ms(torch, fn, reps, flush),
                             library_ms=time_ms(torch, lib, reps,
                                                flush=flush),
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=err[0], err_over_tol=err[1],
                             **decode_stats(torch, name, fn))
            log(f"  {name} at the {shape} decode shape (kv_len "
                f"{'/'.join(map(str, lens))}): {res[name]}")
        out[shape] = {"kv_len": lens, "kernels": res}
    log("DECODE " + json.dumps(out))
    return out


STATE_REL = 1e-4   # float32 over <= 412 steps, summed in another order


def check_state(name, got, want):
    """A WKV6 final state (float32) against its plain version: the largest
    error within STATE_REL of the state's largest |value|."""
    err = float((got - want).abs().max())
    lim = STATE_REL * float(want.abs().max())
    if not math.isfinite(err) or err > lim:
        raise AssertionError(f"{name}: state max abs err {err:.3e} > {lim:.3e}")
    log(f"  {name}: state max abs err {err:.3e} (limit {lim:.3e})")
    return err


def wkv6_checks(torch, reps, flush):
    """The WKV6 kernel against its plain version: float32 at hd 16, then
    rwkv6-1.6b's prefill (B 1, T 300 and 412) and decode (B 4, T 1) shapes,
    each timed beside its plain version and its bound. Printed as ``WKV6``.
    Needs only the wrapper, so it runs on earlier trees too
    (``--wkv6-shape``), for a before and after from one card. Returns the
    kernel's row: the prefill at T 412 from the cache's (zero) state,
    updated in place, as the main path calls it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as kwkv
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-1.6b")
    h, hd = cfg.n_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, t, heads, n, dtype):
        r, k, v, w = (torch.randn((b, t, heads, n), generator=g,
                                  device="cuda") * 0.5 for _ in range(4))
        u = torch.randn((heads, n), generator=g, device="cuda") * 0.5
        s0 = torch.randn((b, heads, n, n), generator=g, device="cuda") * 0.1
        return [x.to(dtype) for x in (r, k, v)] + [w, u, s0]

    r, k, v, w, u, s0 = inputs(2, 45, 4, 16, torch.float32)
    y, s_t = kwkv.wkv6(r, k, v, w, u, s0)
    want_y, want_s = ref.wkv6_reference(r, k, v, w, u, s0)
    check("wkv6 f32 hd16 y", y, want_y, 1e-5)
    check("wkv6 f32 hd16 state", s_t, want_s, 1e-5)

    def held(label, r, k, v, w, u, s0, in_place):
        want_y, want_s = ref.wkv6_reference(r.float(), k.float(), v.float(),
                                            w, u, s0)
        s = s0.clone() if (in_place and s0 is not None) else s0
        y, s_t = kwkv.wkv6(r, k, v, w, u, s,
                           out_state=s if in_place else None)
        torch.cuda.synchronize()
        err = check_rows(f"wkv6 {label} y", y, want_y)
        check_state(f"wkv6 {label}", s_t, want_s)
        return err

    out = {}
    for t in (300, 412):
        r, k, v, w, u, s0 = inputs(1, t, h, hd, torch.bfloat16)
        held(f"bf16 B1 T{t} zero state", r, k, v, w, u, None, False)
        err = held(f"bf16 B1 T{t} random state", r, k, v, w, u, s0, True)
        state = torch.zeros_like(s0)
        b_ms, b_by = bound_ms(*wkv6_cost(r, w, state), F32_FLOPS)
        res = dict(
            **kernel_ms(torch, lambda: kwkv.wkv6(r, k, v, w, u, state,
                                                 out_state=state), reps,
                        flush),
            plain_ms=time_ms(torch, lambda: ref.wkv6_reference(
                r, k, v, w, u, state), max(3, reps // 4), 1, flush),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err[0], err_over_tol=err[1])
        log(f"  wkv6 B1 T{t} (prefill): {res}")
        out[f"prefill B1 T{t}"] = res
    r, k, v, w, u, s0 = inputs(4, 1, h, hd, torch.bfloat16)
    err = held("bf16 B4 T1 (decode) in place", r, k, v, w, u, s0, True)
    b_ms, b_by = bound_ms(*wkv6_cost(r, w, s0), F32_FLOPS)
    out["decode B4 T1"] = dict(
        **kernel_ms(torch, lambda: kwkv.wkv6(r, k, v, w, u, s0,
                                             out_state=s0), reps, flush),
        plain_ms=time_ms(torch, lambda: ref.wkv6_reference(
            r, k, v, w, u, s0), reps, flush=flush),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
        err_over_tol=err[1])
    log(f"  wkv6 B4 T1 (decode): {out['decode B4 T1']}")
    log("WKV6 " + json.dumps(out))
    return out["prefill B1 T412"]


def wkv6_cost(r, w, state):
    """Bytes WKV6 must move (r, k, v read and y written in r's dtype, w
    read, the state read and written) and its float32 operations: per step
    and head, r.S and the rank-1 state update, an FMA (2 operations) per
    state entry each: 4 hd^2 (the O(hd) terms left out)."""
    b, t, h, n = r.shape
    elems = b * t * h * n
    n_bytes = (4 * elems * r.element_size() + elems * w.element_size()
               + h * n * 4 + 2 * state.numel() * 4)
    return n_bytes, 4 * n * n * b * t * h


# ---------------------------------------------------------------------------
# phase 3: serve granite-3-8b at full width
# ---------------------------------------------------------------------------


def drive(torch, ep, prompts, consolidate_after=None, consolidate=None,
          profile_at=None, prefixes=None):
    """Serve ``prompts`` through ``ep`` to the end, timing each step (host
    clock around a synchronised step); ``prefixes`` (one per prompt, None
    where a request has none) are image prefixes. With
    ``consolidate_after``, the endpoint is consolidated by
    ``consolidate()`` once every request has that many tokens. With ``profile_at``, the steps from that index on run
    under the profiler (``profile_steps``) instead of the clock. Returns
    (streams, per-step records, profile or None)."""
    from repro_torch.serving.api import SamplingParams
    prefixes = prefixes or [None] * len(prompts)
    reqs = [ep.submit(p, SamplingParams(max_new=MAX_NEW), prefix_embeds=pre)
            for p, pre in zip(prompts, prefixes)]
    steps, prof = [], None
    while ep.has_work():
        if (consolidate_after is not None and ep.n_stages > 1
                and all(len(r.generated) >= consolidate_after
                        for r in reqs)):
            t0 = time.perf_counter()
            consolidate()
            torch.cuda.synchronize()
            log(f"  consolidated 2 -> 1 stage in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
                f"{ep.last_migration_bytes} KV bytes moved")
        if prof is None and profile_at is not None \
                and len(steps) == profile_at:
            prof = profile_steps(torch, ep.step)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ep.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0,
                      out.prefill_tokens, len(out.events)))
    return [list(r.generated) for r in reqs], steps, prof


def profile_steps(torch, step, n=4):
    """Run ``step()`` ``n`` times under ``torch.profiler``: the device time
    its kernels took per step (summed over kernels; one stream, so they do
    not overlap), the profiled wall time per step, and the kernels with
    the most device time. The profiler's own overhead lengthens the wall
    time, so the device's busy share of an unprofiled step is device ms
    over that step's clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kern[e.key] = e.device_time_total / 1e3 / n      # ms per step
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    ours = {name: sum(v for k, v in kern.items()
                      if f"::{name}<" in k)
            for name in PORT_KERNELS}
    return {"steps": n, "device_ms_per_step": sum(kern.values()),
            "profiled_wall_ms_per_step": wall * 1e3 / n,
            "top_kernels_ms_per_step": {k[:60]: v for k, v in top},
            "port_kernels_ms_per_step": {k: v for k, v in ours.items() if v}}


# the __global__ functions of src/repro_torch/csrc, as the profiler names them
PORT_KERNELS = ("ragged_split_kernel", "ragged_combine_kernel",
                "ragged_span_kernel", "ragged_kernel",
                "paged_decode_mma_kernel", "paged_decode_kernel",
                "flash_wgmma_kernel", "flash_kernel", "decode_mma_kernel",
                "decode_kernel", "decode_combine_kernel", "wkv6_kernel")


def check_bodies(counts, label):
    """Every launch of the attention kernels (each with a tensor-core and a
    CUDA-core body) in ``counts`` (a path's ``launch_counts``) took the
    tensor-core body. Returns the body counts."""
    from repro_torch.kernels import ops
    bodies = ops.body_counts()
    for k in ("ragged_paged_attention", "ragged_paged_attention_q8",
              "paged_decode_attention", "flash_attention",
              "decode_attention"):
        if (bodies[f"{k}/cuda_core"] != 0
                or bodies[f"{k}/tensor_core"] != counts[k]):
            raise AssertionError(f"{label}: {k} launched {counts[k]} times, "
                                 f"by body {bodies}: not all on the tensor "
                                 f"cores")
    log(f"  bodies on {label}: {bodies}")
    return bodies


def profiled_call(torch, fn, names):
    """``fn()`` once under ``torch.profiler`` after one warm-up call: its
    device ms (all kernels; one stream), the ms of the kernels named in
    ``names``, the profiled wall ms and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    ours = sum(v for k, v in kern.items()
               if any(f"::{n}<" in k for n in names))
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
    return (sum(kern.values()), ours, wall * 1e3,
            {k[:60]: v for k, v in top})


def profiled_prefill(torch, model, params, tokens, kw, names):
    """One forward of ``tokens`` through ``Model.prefill(**kw)`` under
    ``torch.profiler``, after one warm-up forward (``profiled_call``)."""
    return profiled_call(torch, lambda: model.prefill(params, tokens, 1024,
                                                      **kw), names)


def prefill_profile(torch, model, params, prompt):
    """One forward of ``prompt`` (one sequence) through ``Model.prefill``
    under ``torch.profiler`` on each layout: ``paged=False`` (flash
    attention) and ``paged=True`` over bf16 and over int8 pages (the ragged
    kernel), each after one warm-up forward. Returns, per layout, the
    forward's device ms (all kernels; one stream) and the attention
    kernel's ms and share of it."""
    tokens = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    flash = ("flash_wgmma_kernel", "flash_kernel")
    ragged = ("ragged_split_kernel", "ragged_combine_kernel",
              "ragged_span_kernel", "ragged_kernel")
    res = {}
    for label, kw, names in (
            ("contiguous (flash)", dict(paged=False), flash),
            ("paged, bf16 pages (ragged)", dict(paged=True), ragged),
            ("paged, int8 pages (ragged)", dict(paged=True, kv_dtype="int8"),
             ragged)):
        total, attn, wall, top = profiled_prefill(torch, model, params,
                                                  tokens, kw, names)
        res[label] = {"tokens": len(prompt), "device_ms": total,
                      "attention_kernel_ms": attn,
                      "attention_share": attn / total if total else None,
                      "profiled_wall_ms": wall, "top_kernels_ms": top}
        log(f"  prefill of {len(prompt)} tokens, {label}: device "
            f"{total:.3f} ms, attention kernel {attn:.3f} ms "
            f"({res[label]['attention_share']:.3f} of it); profiled wall "
            f"{wall:.1f} ms")
    log("PREFILL " + json.dumps(res))
    return res


def rwkv_prefill_profile(torch, model, params, prompt):
    """One forward of ``prompt`` through rwkv6-1.6b's ``Model.prefill``
    (slot-contiguous, the only layout of a recurrent model's prefill) under
    ``torch.profiler``: its device ms and the wkv6 kernel's ms and share.
    Printed as ``RWKV_PREFILL``."""
    total, wkv, wall, top = profiled_prefill(
        torch, model, params,
        torch.tensor([prompt], dtype=torch.int32, device="cuda"),
        dict(paged=False), ("wkv6_kernel",))
    pre = {"tokens": len(prompt), "device_ms": total, "wkv6_kernel_ms": wkv,
           "wkv6_share": wkv / total if total else None,
           "profiled_wall_ms": wall, "top_kernels_ms": top}
    if not wkv > 0:
        raise AssertionError("rwkv prefill profile: no wkv6 kernel time")
    log(f"  rwkv prefill of {len(prompt)} tokens, contiguous: device "
        f"{total:.3f} ms, wkv6 kernel {wkv:.3f} ms ({pre['wkv6_share']:.3f} "
        f"of it); profiled wall {wall:.1f} ms")
    log("RWKV_PREFILL " + json.dumps(pre))
    return pre


def prefill_profile_phase(torch):
    """``--prefill-profile``: full-depth granite-3-8b on random weights,
    the prefill profile alone, then rwkv6-1.6b's (both run on an earlier
    tree too, for a before and after from one card)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    for name, profile in (("granite-3-8b", prefill_profile),
                          ("rwkv6-1.6b", rwkv_prefill_profile)):
        cfg = get_config(name)
        model = Model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        profile(torch, model, params, main_prompts(cfg.vocab)[2])
        del params
        gc.collect()
        torch.cuda.empty_cache()


def divergence_witness(torch, model, params, prompts, streams, q8_streams):
    """Where a request's int8 stream leaves its bf16 stream, the logits at
    the first diverging token, from one prefill of the prompt and the
    tokens both streams share: with bf16 pages and with int8 pages, each
    through the kernel and through the plain ragged version (swapped into
    ``ops`` for that one call; the served path never runs it). Returns one
    record per request; margins and deviations are in logits, over the
    real vocabulary."""
    import contextlib
    from unittest import mock
    from repro_torch.kernels import ops, ref
    vocab = model.cfg.vocab
    device = params["final_norm"].device
    records = []
    for i, (p, a, b) in enumerate(zip(prompts, streams, q8_streams)):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            records.append({"request": i, "first_diverging": None})
            continue
        ctx = torch.tensor([p + a[:j]], dtype=torch.int32, device=device)

        def logits(kv_dtype, plain=False):
            swap = (mock.patch.object(ops, "ragged_paged_attention",
                                      ref.ragged_paged_attention_reference)
                    if plain else contextlib.nullcontext())
            with swap:
                lg, _ = model.prefill(params, ctx, 1024, kv_dtype=kv_dtype)
            return lg[0, :vocab].float()

        lb, lbp = logits(None), logits(None, plain=True)
        l8, l8p = logits("int8"), logits("int8", plain=True)
        top2 = lb.topk(2).values
        records.append({
            "request": i, "first_diverging": j, "of": len(a),
            "bf16_token": a[j], "int8_token": b[j],
            "prefill_argmax_bf16": int(lb.argmax()),
            "prefill_argmax_int8": int(l8.argmax()),
            "bf16_top2_margin": float(top2[0] - top2[1]),
            "bf16_gap": float(lb[a[j]] - lb[b[j]]),
            "int8_gap": float(l8[b[j]] - l8[a[j]]),
            "logit_std": float(lb.std()),
            "int8_vs_bf16_max": float((l8 - lb).abs().max()),
            "kernel_vs_plain_max_bf16": float((lb - lbp).abs().max()),
            "kernel_vs_plain_max_int8": float((l8 - l8p).abs().max()),
        })
    return records


def layout_witness(torch, model, params, prompts, streams, pg_streams):
    """Where a request's slot-contiguous stream leaves its paged stream, the
    logits at the first diverging token from one prefill of the prompt and
    the tokens both streams share, on each layout (flash kernel into
    contiguous slabs; ragged kernel into paged pools). Returns one record
    per request; margins and shifts are in logits, over the real
    vocabulary. Reported, not asserted."""
    vocab = model.cfg.vocab
    device = params["final_norm"].device
    records = []
    for i, (p, a, b) in enumerate(zip(prompts, streams, pg_streams)):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            records.append({"request": i, "first_diverging": None})
            continue
        ctx = torch.tensor([p + a[:j]], dtype=torch.int32, device=device)
        lc = model.prefill(params, ctx, 1024, paged=False)[0][0, :vocab]
        lp = model.prefill(params, ctx, 1024, paged=True)[0][0, :vocab]
        lc, lp = lc.float(), lp.float()
        top2 = lc.topk(2).values
        records.append({
            "request": i, "first_diverging": j, "of": len(a),
            "contiguous_token": a[j], "paged_token": b[j],
            "prefill_argmax_contiguous": int(lc.argmax()),
            "prefill_argmax_paged": int(lp.argmax()),
            "contiguous_top2_margin": float(top2[0] - top2[1]),
            "contiguous_gap": float(lc[a[j]] - lc[b[j]]),
            "logit_std": float(lc.std()),
            "layout_shift_max": float((lc - lp).abs().max()),
        })
    return records


def step_stats(steps):
    pre = [(t, n) for t, n, _ in steps if n > 0]
    dec = [(t, e) for t, n, e in steps if n == 0]
    ms = sorted(t * 1e3 for t, _, _ in steps)
    dms = sorted(t * 1e3 for t, _ in dec)

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))] \
            if xs else float("nan")

    return {
        "prefill_tok_s": sum(n for _, n in pre) / max(sum(t for t, _ in pre),
                                                      1e-9),
        "decode_tok_s": sum(e for _, e in dec) / max(sum(t for t, _ in dec),
                                                     1e-9),
        "step_ms_p50": pct(ms, 0.5), "step_ms_p99": pct(ms, 0.99),
        "decode_step_ms_p50": pct(dms, 0.5),
        "decode_step_ms_p99": pct(dms, 0.99),
        "steps": len(steps),
    }


def main_prompts(vocab):
    """The four requests of every serve: prompts of 300, 257, 412 and 190
    tokens from a seeded generator."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in (300, 257, 412, 190)]


def serve_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.attention import paged_kv_token_bytes
    from repro_torch.models.model import Model
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine

    cfg = get_config("granite-3-8b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    log(f"  granite-3-8b: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in {cfg.dtype}, drawn in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = main_prompts(cfg.vocab)
    kw = dict(max_batch=4, max_seq=1024, block_size=16, paged=True,
              prefill_chunk=256, device="cuda")
    results = {}

    # the main path: 2-stage endpoint, consolidated mid-stream
    stages = [model.slice_stage_params(params, 2, i) for i in range(2)]
    ep = ServingEndpoint(Engine(cfg, stages, **kw))
    ops.reset_launch_counts()
    streams, steps, _ = drive(torch, ep, prompts, consolidate_after=4,
                              consolidate=lambda: ep.consolidate(params))
    torch.cuda.synchronize()
    main_counts = ops.launch_counts()
    if ep.n_stages != 1:
        raise AssertionError("endpoint was not consolidated")
    results["2-stage -> consolidated, bf16 KV"] = step_stats(steps)
    log(f"  launches on the main path: {main_counts}")
    for k in ("ragged_paged_attention", "paged_decode_attention"):
        if main_counts[k] <= 0:
            raise AssertionError(f"{k} never launched on the main path")
    main_bodies = check_bodies(main_counts, "the main path")
    del ep

    ref_ep = ServingEndpoint(Engine(cfg, [params], **kw))
    ref_streams, ref_steps, ref_prof = drive(torch, ref_ep, prompts,
                                             profile_at=PROFILE_AT)
    results["1-stage, bf16 KV"] = step_stats(ref_steps)
    if streams != ref_streams:
        raise AssertionError(f"2-stage + consolidation streams differ from "
                             f"the 1-stage engine's:\n{streams}\n"
                             f"{ref_streams}")
    if not all(len(s) == MAX_NEW and all(0 <= t < cfg.vocab for t in s)
               for s in streams):
        raise AssertionError(f"bad streams {streams}")
    log("  streams: 2-stage + consolidation == 1-stage engine "
        f"(first request: {streams[0][:8]} ...)")
    del ref_ep

    # the int8 path: fused ragged steps over int8 KV pages
    q8 = ServingEndpoint(Engine(cfg, [params], fused=True, kv_dtype="int8",
                                **kw))
    ops.reset_launch_counts()
    q8_streams, q8_steps, q8_prof = drive(torch, q8, prompts,
                                          profile_at=PROFILE_AT)
    torch.cuda.synchronize()
    q8_counts = ops.launch_counts()
    results["1-stage fused, int8 KV"] = step_stats(q8_steps)
    log(f"  launches on the int8 path: {q8_counts}")
    if q8_counts["ragged_paged_attention_q8"] <= 0:
        raise AssertionError("the int8 ragged body never launched")
    q8_bodies = check_bodies(q8_counts, "the int8 path")
    if not all(len(s) == MAX_NEW for s in q8_streams):
        raise AssertionError(f"bad int8 streams {q8_streams}")
    agree = sum(a == b for s, r in zip(q8_streams, streams)
                for a, b in zip(s, r)) / sum(len(s) for s in streams)
    log(f"  int8 streams agree with bf16 on {agree:.3f} of tokens")
    del q8
    witness = divergence_witness(torch, model, params, prompts, streams,
                                 q8_streams)
    for w in witness:
        log(f"  int8 vs bf16 stream, first divergence: {w}")
    for w in witness:
        if w["first_diverging"] is None:
            continue
        # the streams part at a near-tie: within how far int8 pages move
        # the logits
        if not w["bf16_top2_margin"] <= w["int8_vs_bf16_max"]:
            raise AssertionError(f"request {w['request']}: the streams part "
                                 f"where int8 pages cannot flip the choice")
        # the int8 body strays from its plain version no further than the
        # fp body from its own, to a factor 2 (floor: 2^-5, one bf16 step
        # of a logit between 4 and 8)
        if not (w["kernel_vs_plain_max_int8"]
                <= 2 * max(w["kernel_vs_plain_max_bf16"], 2.0 ** -5)):
            raise AssertionError(f"request {w['request']}: the int8 kernel's "
                                 f"logits stray from its plain version's")

    kv_bytes = {"bf16": paged_kv_token_bytes(cfg),
                "int8": paged_kv_token_bytes(cfg, "int8")}
    if kv_bytes != {"bf16": 4096, "int8": 2176}:
        raise AssertionError(f"KV bytes/token/layer {kv_bytes}")
    for name, r in results.items():
        log(f"  {name}: prefill {r['prefill_tok_s']:.1f} tok/s, decode "
            f"{r['decode_tok_s']:.1f} tok/s, step p50 {r['step_ms_p50']:.2f}"
            f" ms p99 {r['step_ms_p99']:.2f} ms, decode step p50 "
            f"{r['decode_step_ms_p50']:.2f} ms p99 "
            f"{r['decode_step_ms_p99']:.2f} ms, {r['steps']} steps")
    log(f"  KV bytes/token/layer: {kv_bytes}")
    profiles = {"1-stage, bf16 KV": ref_prof,
                "1-stage fused, int8 KV": q8_prof}
    for name, pr in profiles.items():
        if pr is None:
            raise AssertionError(f"{name}: served in fewer than "
                                 f"{PROFILE_AT} steps, nothing profiled")
        log(f"  {name}, {pr['steps']} decode steps profiled: device "
            f"{pr['device_ms_per_step']:.2f} ms a step (profiled wall "
            f"{pr['profiled_wall_ms_per_step']:.2f} ms); top kernels "
            f"{pr['top_kernels_ms_per_step']}")
    prefill = prefill_profile(torch, model, params, prompts[2])
    log("SERVE " + json.dumps({"results": results, "kv_bytes": kv_bytes,
                               "launches_main": main_counts,
                               "launches_int8": q8_counts,
                               "bodies_main": main_bodies,
                               "bodies_int8": q8_bodies,
                               "prefill_profile": prefill,
                               "int8_token_agreement": agree,
                               "int8_divergence": witness,
                               "profiles": profiles}))
    return {"ragged_paged_attention": main_counts["ragged_paged_attention"],
            "paged_decode_attention": main_counts["paged_decode_attention"],
            "ragged_paged_attention_q8":
                q8_counts["ragged_paged_attention_q8"]}


# ---------------------------------------------------------------------------
# phases 4-5: cold start through the ServerlessFrontend, slot-contiguous
# ---------------------------------------------------------------------------


SERVE_KW = dict(max_batch=4, max_seq=1024)


def frontend(torch):
    """``examples/quickstart.py``'s cluster: 4 servers of one card each
    (16 Gbps NIC, 12 GB/s PCIe, the H100's 80 GB), all on this card."""
    from repro_torch.core import GB, Gbps, ServerSpec
    from repro_torch.serving.endpoint import ServerlessFrontend
    return ServerlessFrontend({f"srv{i}": ServerSpec(f"srv{i}", 16 * Gbps,
                                                     12e9, 80 * GB)
                               for i in range(4)}, device="cuda")


def profile_of(model):
    """Alg. 1's inputs: the model's real byte count, the paper's timing
    defaults and the quickstart's SLO (simulated clock, not measured)."""
    from repro_torch.core import ModelProfile, SLO, TimingProfile
    return ModelProfile(model.cfg.name, model.bytes(), TimingProfile(),
                        SLO(ttft=7.5, tpot=0.2))


def timed(torch, fn, out, label):
    """``fn`` wrapped to append (label, wall seconds) to ``out``, the card
    synchronised before and after: the measured host -> card load."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        torch.cuda.synchronize()
        out.append((label, time.perf_counter() - t0))
        return res
    return run


def cold_start(torch, front, name, loads):
    """``front.cold_start(name, min_stages=2, paged=False, ...)``, split
    into ``begin_cold_start`` + ``finish`` only so each stage's
    ``materialize()`` is timed on the wall clock."""
    pend = front.begin_cold_start(name, min_stages=2, paged=False,
                                  **SERVE_KW)
    for i, st in enumerate(pend.stages):
        st.materialize = timed(torch, st.materialize, loads, f"stage{i}")
    return pend.finish()


def load_rates(loads, store, s):
    nbytes = {f"stage{i}": store.stage_bytes(s, i) for i in range(s)}
    nbytes["full_params"] = store.total_bytes
    return {label: {"seconds": t, "bytes": nbytes[label],
                    "GB_per_s": nbytes[label] / t / 1e9}
            for label, t in loads}


def coldstart_phase(torch, prompts):
    """The main path of the slot-contiguous layout, through the entry
    points a user calls (``examples/quickstart.py``'s steps) at full width
    and depth. Returns the flash/decode launch counts of its serve."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine

    cfg = get_config("granite-3-8b")
    model = Model(cfg)
    name = cfg.name
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    front = frontend(torch)
    t0 = time.perf_counter()
    store = front.deploy(cfg, params, profile_of(model))
    deploy_s = time.perf_counter() - t0
    del params                       # the store's memory tier holds them
    torch.cuda.empty_cache()
    log(f"  deployed {store.total_bytes / 2**30:.2f} GiB into the memory "
        f"tier ({len(store.manifest.chunks)} chunks) in {deploy_s:.1f} s")

    loads = []
    ep = cold_start(torch, front, name, loads)
    sch = ep.scheme
    log(f"  Alg. 1 scheme: s={sch.s} w={sch.w} servers={sch.servers} "
        f"pred_ttft={sch.predicted_ttft:.3f} s pred_tpot="
        f"{sch.predicted_tpot:.4f} s slo_ok={sch.slo_ok} -> "
        f"{ep.n_stages}-stage pipeline")
    timeline = ep.cold_start_timeline.to_json()
    for st in timeline["stages"]:
        log(f"  cold-start timeline (simulated clock), stage {st['stage']}"
            f" on {st['server']}: ready {st['ready']:.3f} s, spans "
            + ", ".join(f"{k} {a:.3f}-{b:.3f}"
                        for k, (a, b) in st["spans"].items()))
    if ep.n_stages != 2 or ep.paged:
        raise AssertionError("expected a 2-stage slot-contiguous endpoint")

    front.full_params = timed(torch, front.full_params, loads, "full_params")
    ops.reset_launch_counts()
    streams, steps, _ = drive(torch, ep, prompts, consolidate_after=4,
                              consolidate=lambda: front.consolidate(ep, name))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"  launches on the cold-start path: {counts}")
    if ep.n_stages != 1:
        raise AssertionError("endpoint was not consolidated")
    for k in ("flash_attention", "decode_attention"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} never launched on the cold-start path")
    bodies = check_bodies(counts, "the cold-start path")
    for k in ("ragged_paged_attention", "ragged_paged_attention_q8",
              "paged_decode_attention"):
        if counts[k] != 0:
            raise AssertionError(f"{k} launched on the contiguous path")
    if ep.last_migration_bytes is not None:
        raise AssertionError("a contiguous consolidation counts no bytes")
    rates = load_rates(loads, store, 2)
    for label, r in rates.items():
        log(f"  measured wall time of {label} (host -> card): "
            f"{r['seconds']:.3f} s for {r['bytes'] / 2**30:.2f} GiB, "
            f"{r['GB_per_s']:.2f} GB/s")
    results = {"2-stage -> consolidated, contiguous": step_stats(steps)}

    full = ep.engine.workers[0].params
    one = ServingEndpoint(Engine(cfg, [full], paged=False, device="cuda",
                                 **SERVE_KW))
    one_streams, one_steps, one_prof = drive(torch, one, prompts,
                                             profile_at=PROFILE_AT)
    results["1-stage, contiguous"] = step_stats(one_steps)
    if streams != one_streams:
        raise AssertionError(f"cold start + consolidation streams differ "
                             f"from the 1-stage contiguous engine's:\n"
                             f"{streams}\n{one_streams}")
    if not all(len(s) == MAX_NEW and all(0 <= t < cfg.vocab for t in s)
               for s in streams):
        raise AssertionError(f"bad streams {streams}")
    log("  streams: cold start 2-stage + consolidation == 1-stage "
        f"contiguous engine (first request: {streams[0][:8]} ...)")
    del one
    paged = ServingEndpoint(Engine(cfg, [full], paged=True, block_size=16,
                                   prefill_chunk=256, device="cuda",
                                   **SERVE_KW))
    pg_streams, pg_steps, pg_prof = drive(torch, paged, prompts,
                                          profile_at=PROFILE_AT)
    results["1-stage, paged (same call)"] = step_stats(pg_steps)
    agree = sum(a == b for s, r in zip(streams, pg_streams)
                for a, b in zip(s, r)) / sum(len(s) for s in streams)
    log(f"  contiguous streams agree with the paged engine's on "
        f"{agree:.3f} of tokens (not asserted)")
    del paged, ep
    witness = layout_witness(torch, model, full, prompts, streams, pg_streams)
    for w in witness:
        log(f"  contiguous vs paged stream, first divergence: {w}")
    del full
    for label, r in results.items():
        log(f"  {label}: prefill {r['prefill_tok_s']:.1f} tok/s, decode "
            f"{r['decode_tok_s']:.1f} tok/s, decode step p50 "
            f"{r['decode_step_ms_p50']:.2f} ms p99 "
            f"{r['decode_step_ms_p99']:.2f} ms, {r['steps']} steps")
    profiles = {"1-stage, contiguous": one_prof,
                "1-stage, paged (same call)": pg_prof}
    for label, pr in profiles.items():
        if pr is None:
            raise AssertionError(f"{label}: nothing profiled")
        log(f"  {label}, {pr['steps']} decode steps profiled: device "
            f"{pr['device_ms_per_step']:.2f} ms a step (profiled wall "
            f"{pr['profiled_wall_ms_per_step']:.2f} ms); top kernels "
            f"{pr['top_kernels_ms_per_step']}")
    log("COLDSTART " + json.dumps({
        "scheme": {"s": sch.s, "w": sch.w, "servers": list(sch.servers),
                   "predicted_ttft_s": sch.predicted_ttft,
                   "predicted_tpot_s": sch.predicted_tpot,
                   "slo_ok": sch.slo_ok},
        "timeline_simulated": timeline, "deploy_s": deploy_s,
        "loads_measured": rates, "results": results, "launches": counts,
        "bodies": bodies,
        "paged_token_agreement": agree, "layout_divergence": witness,
        "profiles": profiles}))
    return {k: counts[k] for k in ("flash_attention", "decode_attention")}


ATTN_KERNELS = ("ragged_paged_attention", "ragged_paged_attention_q8",
                "paged_decode_attention", "flash_attention",
                "decode_attention")


def rwkv_phase(torch):
    """The path of the WKV6 kernel: rwkv6-1.6b at full width and depth
    through the same cold start as phase 4 (``ServerlessFrontend`` ->
    memory tier -> Alg. 1 -> 2 slot-contiguous stages -> consolidation
    through ``full_params``), held exactly against 1-stage contiguous and
    paged engines on the same weights. Returns the wkv6 launch count of
    its serve."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine

    cfg = get_config("rwkv6-1.6b")
    model = Model(cfg)
    name = cfg.name
    prompts = main_prompts(cfg.vocab)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    state_bytes = cfg.n_layers * (cfg.n_heads * cfg.head_dim ** 2 * 4
                                  + cfg.d_model * 2)
    log(f"  rwkv6-1.6b: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, {n_params / 1e9:.3f} B "
        f"params in {cfg.dtype} ({model.bytes() / 1e9:.3f} GB), drawn in "
        f"{time.perf_counter() - t0:.1f} s; recurrent state "
        f"{state_bytes / 1e6:.2f} MB a slot")
    # one profiled prefill, far from the decode profile of the serve below
    rwkv_prefill_profile(torch, model, params, prompts[2])
    front = frontend(torch)
    t0 = time.perf_counter()
    store = front.deploy(cfg, params, profile_of(model))
    deploy_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    log(f"  deployed {store.total_bytes / 2**30:.2f} GiB into the memory "
        f"tier ({len(store.manifest.chunks)} chunks) in {deploy_s:.1f} s")

    loads = []
    ep = cold_start(torch, front, name, loads)
    sch = ep.scheme
    log(f"  Alg. 1 scheme: s={sch.s} w={sch.w} servers={sch.servers} "
        f"pred_ttft={sch.predicted_ttft:.3f} s pred_tpot="
        f"{sch.predicted_tpot:.4f} s slo_ok={sch.slo_ok} -> "
        f"{ep.n_stages}-stage pipeline")
    timeline = ep.cold_start_timeline.to_json()
    for st in timeline["stages"]:
        log(f"  cold-start timeline (simulated clock), stage {st['stage']}"
            f" on {st['server']}: ready {st['ready']:.3f} s, spans "
            + ", ".join(f"{k} {a:.3f}-{b:.3f}"
                        for k, (a, b) in st["spans"].items()))
    if ep.n_stages != 2 or ep.paged:
        raise AssertionError("expected a 2-stage slot-contiguous endpoint")

    front.full_params = timed(torch, front.full_params, loads, "full_params")
    ops.reset_launch_counts()
    streams, steps, _ = drive(torch, ep, prompts, consolidate_after=4,
                              consolidate=lambda: front.consolidate(ep, name))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"  launches on the rwkv path: {counts}")
    if ep.n_stages != 1:
        raise AssertionError("endpoint was not consolidated")
    # one launch a layer for each prompt's prefill and each decode step
    # (every request's first token comes from its prefill)
    n_prefill = cfg.n_layers * len(prompts)
    n_decode = cfg.n_layers * (MAX_NEW - 1)
    if counts["wkv6"] != n_prefill + n_decode:
        raise AssertionError(f"wkv6 launched {counts['wkv6']} times on the "
                             f"rwkv path, not {n_prefill} prefill + "
                             f"{n_decode} decode")
    log(f"  wkv6 launches: {n_prefill} prefill + {n_decode} decode")
    for k in ATTN_KERNELS:
        if counts[k] != 0:
            raise AssertionError(f"{k} launched on an attention-free model")
    rates = load_rates(loads, store, 2)
    for label, r in rates.items():
        log(f"  measured wall time of {label} (host -> card): "
            f"{r['seconds']:.3f} s for {r['bytes'] / 2**30:.2f} GiB, "
            f"{r['GB_per_s']:.2f} GB/s")
    results = {"2-stage -> consolidated, contiguous": step_stats(steps)}

    full = ep.engine.workers[0].params
    del ep
    one = ServingEndpoint(Engine(cfg, [full], paged=False, device="cuda",
                                 **SERVE_KW))
    one_streams, one_steps, one_prof = drive(torch, one, prompts,
                                             profile_at=PROFILE_AT)
    results["1-stage, contiguous"] = step_stats(one_steps)
    del one
    paged = ServingEndpoint(Engine(cfg, [full], paged=True, block_size=16,
                                   device="cuda", **SERVE_KW))
    pg_streams, pg_steps, _ = drive(torch, paged, prompts)
    results["1-stage, paged"] = step_stats(pg_steps)
    del paged, full
    for label, other in (("1-stage contiguous", one_streams),
                         ("1-stage paged", pg_streams)):
        if streams != other:
            raise AssertionError(f"rwkv cold start + consolidation streams "
                                 f"differ from the {label} engine's:\n"
                                 f"{streams}\n{other}")
    if not all(len(s) == MAX_NEW and all(0 <= t < cfg.vocab for t in s)
               for s in streams):
        raise AssertionError(f"bad streams {streams}")
    log("  streams: rwkv cold start 2-stage + consolidation == 1-stage "
        f"contiguous == 1-stage paged (first request: {streams[0][:8]} ...)")
    for label, r in results.items():
        log(f"  {label}: prefill {r['prefill_tok_s']:.1f} tok/s, decode "
            f"{r['decode_tok_s']:.1f} tok/s, decode step p50 "
            f"{r['decode_step_ms_p50']:.2f} ms p99 "
            f"{r['decode_step_ms_p99']:.2f} ms, {r['steps']} steps")
    if one_prof is None:
        raise AssertionError("1-stage contiguous: nothing profiled")
    busy = (one_prof["device_ms_per_step"]
            / results["1-stage, contiguous"]["decode_step_ms_p50"])
    log(f"  1-stage contiguous, {one_prof['steps']} decode steps profiled: "
        f"device {one_prof['device_ms_per_step']:.2f} ms a step (profiled "
        f"wall {one_prof['profiled_wall_ms_per_step']:.2f} ms), busy "
        f"{busy:.3f} of the unprofiled decode-step p50; top kernels "
        f"{one_prof['top_kernels_ms_per_step']}; the port's kernels "
        f"{one_prof['port_kernels_ms_per_step']}")
    log("RWKV " + json.dumps({
        "scheme": {"s": sch.s, "w": sch.w, "servers": list(sch.servers),
                   "predicted_ttft_s": sch.predicted_ttft,
                   "predicted_tpot_s": sch.predicted_tpot,
                   "slo_ok": sch.slo_ok},
        "timeline_simulated": timeline, "deploy_s": deploy_s,
        "loads_measured": rates, "results": results, "launches": counts,
        "state_bytes_per_slot": state_bytes, "streams_equal": True,
        "profile": one_prof, "device_busy": busy}))
    return {"wkv6": counts["wkv6"]}


def disk_tier_phase(torch, prompts):
    """Full width, depth cut to 4 layers: the memory tier's streams against
    a cold deploy (``params=None``) from an on-disk store written by
    ``deploy(..., store_dir=...)``, each served through a cold start to 2
    stages and a consolidation. The store lives inside the checkout and is
    deleted after."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    streams = {}
    store_dir = ROOT / "_smoke_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    try:
        mem = frontend(torch)
        mem.deploy(cfg, params, profile_of(model))
        writer = frontend(torch)
        t0 = time.perf_counter()
        store = writer.deploy(cfg, params, profile_of(model),
                              store_dir=str(store_dir))
        write_s = time.perf_counter() - t0
        del params, writer
        torch.cuda.empty_cache()
        cold = frontend(torch)
        cold.deploy(cfg, None, profile_of(model), store_dir=str(store_dir))
        rates = {}
        for label, front in (("memory", mem), ("disk", cold)):
            loads = []
            ep = cold_start(torch, front, cfg.name, loads)
            front.full_params = timed(torch, front.full_params, loads,
                                      "full_params")
            streams[label], _, _ = drive(
                torch, ep, prompts, consolidate_after=4,
                consolidate=lambda: front.consolidate(ep, cfg.name))
            rates[label] = load_rates(loads, front.store_of(cfg.name), 2)
            del ep
        log(f"  store written: {store.total_bytes / 2**30:.2f} GiB in "
            f"{write_s:.1f} s; loads (measured wall, host -> card): "
            f"{json.dumps(rates)}")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    if streams["disk"] != streams["memory"]:
        raise AssertionError(f"cold deploy from disk serves other streams "
                             f"than the memory tier:\n{streams}")
    log("  disk tier (4 of 40 layers): cold deploy from the store serves the "
        "memory tier's streams")
    log("DISK " + json.dumps({"layers": cfg.n_layers, "write_s": write_s,
                              "loads_measured": rates,
                              "streams_equal": True}))


# ---------------------------------------------------------------------------
# phase 7: multi-tier KV spill/restore, KV-aware routing, the sanitizer
# ---------------------------------------------------------------------------

TIER_PROMPT = 300           # tokens a prompt: 18 full blocks of 16
TIER_NEW = 4
TIER_CHURN = 6              # distinct prompts pushed through replica A
TIER_HOST_BLOCKS = 24       # the host tier's budget; the rest demotes
TIER_KW = dict(max_batch=2, max_seq=512, block_size=16, paged=True,
               prefix_cache=True)          # 2 x (512 / 16 + 1) = 66 blocks
TIER_BLOCK_BYTES = {None: 2_621_440, "int8": 1_392_640}   # 16 x B/tok x 40
TIER_TURNS, TIER_TURN_NEW = 3, 16   # A and B in turns: the checks' cost


def tier_prompts(vocab):
    """P1, P2 and the churn prompts C1.. of the tier phase, from a seed."""
    import numpy as np
    rng = np.random.RandomState(7)
    names = ["P1", "P2"] + [f"C{i}" for i in range(1, TIER_CHURN + 1)]
    return {n: rng.randint(0, vocab, TIER_PROMPT).tolist() for n in names}


def serve_one(torch, ep, prompt, sanitize, steps=None, max_new=TIER_NEW):
    """Serve one request on ``ep`` to its end, with dispatch's kernel
    contract checks on while ``sanitize``; appends each step's (seconds,
    prefill tokens, events) to ``steps`` where one is given, on the host
    clock around a synchronised step. Returns the request's stream."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import SamplingParams

    def sync():
        if ep.engine.device.type == "cuda":
            torch.cuda.synchronize()

    ops.set_sanitize_mode(sanitize)
    try:
        req = ep.submit(prompt, SamplingParams(max_new=max_new))
        while ep.has_work():
            sync()
            t0 = time.perf_counter()
            out = ep.step()
            sync()
            if steps is not None:
                steps.append((time.perf_counter() - t0, out.prefill_tokens,
                              len(out.events)))
    finally:
        ops.set_sanitize_mode(False)
    return list(req.generated)


def restores_by_tier(tier):
    """A tier's restores so far, by the tier each came from (a restore's
    flow is capped at its source tier's bandwidth)."""
    host = sum(f.cap == tier.host_bw for f in tier.restore_flows)
    return {"host": host, "segment": len(tier.restore_flows) - host}


def check_tier_bytes(label, tier, block):
    """Every spilled and restored block moved exactly ``block`` bytes."""
    s = tier.stats()
    if (s["spilled_bytes"] != s["spills"] * block
            or s["restored_bytes"] != s["restores"] * block):
        raise AssertionError(f"{label}: tier bytes {s} are not "
                             f"{block} B a block")
    return s


def check_sanitizer(label, ep):
    san = ep.engine.sanitizer
    san.check_idle()
    if san.findings:
        raise AssertionError(f"{label}: {san.report()}")
    return san.events


def page_rates(torch, runner, n_blocks, block):
    """Wall GB/s of ``read_pages`` (card -> host) and ``write_pages`` (host
    -> card) of ``n_blocks`` blocks, synchronised around each."""
    blocks = list(range(n_blocks))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads = [runner.read_pages(b) for b in blocks]
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b, p in zip(blocks, payloads):
        runner.write_pages(b, p)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    nbytes = n_blocks * block
    return {"blocks": n_blocks, "bytes": nbytes,
            "spill_read_s": read_s, "spill_GB_per_s": nbytes / read_s / 1e9,
            "restore_write_s": write_s,
            "restore_GB_per_s": nbytes / write_s / 1e9}


def kernelcheck_cost(torch, cfg, n_blocks, reps=200):
    """Host microseconds a call of each contract check takes on card
    tensors at a decode step's shapes of the tier replicas (batch 2, a
    table of 33 blocks over a 67-page bf16 pool), its host reads and
    synchronisation included."""
    from repro_torch.analysis import kernelcheck
    from repro_torch.kernels.ragged_attention import TILE_Q
    dev = "cuda"
    hd, hkv, hq = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    nb = TIER_KW["max_seq"] // TIER_KW["block_size"] + 1
    pages = torch.zeros(n_blocks + 1, TIER_KW["block_size"], hkv, hd,
                        dtype=torch.bfloat16, device=dev)
    tables = torch.zeros(2, nb, dtype=torch.int32, device=dev)
    kv_len = torch.tensor([300, 301], dtype=torch.int32, device=dev)
    q = torch.zeros(2, 1, hq, hd, dtype=torch.bfloat16, device=dev)
    qr = torch.zeros(2 * TILE_Q, hq, hd, dtype=torch.bfloat16, device=dev)
    row = torch.repeat_interleave(torch.arange(2, dtype=torch.int32,
                                               device=dev), TILE_Q)
    pos = torch.full((2 * TILE_Q,), -1, dtype=torch.int32, device=dev)
    out = {}
    for name, fn in (
            ("check_paged_decode_us", lambda: kernelcheck.check_paged_decode(
                q, pages, pages, tables, kv_len)),
            ("check_ragged_paged_us", lambda: kernelcheck.check_ragged_paged(
                qr, pages, pages, tables, row, pos))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def tier_phase(torch):
    """Multi-tier KV spill/restore and KV-aware routing on the paged engine,
    with the KV-lifecycle sanitizer and the kernel contract checks on.
    granite-3-8b at full width and depth, bf16, paged, block 16, on the
    card; weights drawn once from a seeded generator. Replica A (sanitized, strict) and
    replica B (not) share the weights, one ``KVBlockStore`` (24 host
    blocks, then the segment tier) and one ``Router("kv_affinity")``:

    1. P1 and P2 on A, each twice (the second is a warm prefix hit: W1, W2);
    2. six distinct prompts churn A's 66-block pool: 144 blocks pass
       through it, evictions spill to the host tier, which demotes its
       overflow to the segment tier;
    3. P1 on A again: restored from the tiers, its stream must be W1;
    4. P2 through the router, which picks B: B restores A's spilled blocks
       and must serve W2 (the same prompt on the sanitized and the plain
       replica);
    5. the churn prompt with the most blocks in the host tier (those left
       A's pool during step 3) through the router, which picks B: B
       restores them from the host tier and must serve A's stream;
    6. P2 with 16 new tokens on A, then on B, three times over: their
       decode steps in turns give the sanitizer's and the checks' cost.

    Spilled and restored bytes are held to 2,621,440 B a block, the
    sanitizer to no finding, every ragged and paged decode launch to the
    tensor-core body. A fused int8 replica with its own tier repeats 1-3
    (1,392,640 B a block). Reported, not asserted: cold vs warm streams,
    the host <-> card rates of ``read_pages``/``write_pages``, the decode
    step p50 of A and B in the turns of step 6 (their steps over the whole
    phase come from different requests, so only the turns compare them),
    what each contract check costs, the router's decisions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.attention import paged_kv_token_bytes
    from repro_torch.models.model import Model
    from repro_torch.router import KVBlockStore, Router
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine

    device = "cuda"
    cfg = get_config("granite-3-8b")
    model = Model(cfg)
    t_phase = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    prompts = tier_prompts(cfg.vocab)

    def replica(tier, sanitize, **kw):
        ep = ServingEndpoint(Engine(cfg, [params], **TIER_KW, kv_tier=tier,
                                    sanitize=sanitize, device=device, **kw))
        if sanitize:
            ep.engine.sanitizer.strict = True    # raise at the first finding
        return ep

    def block_bytes(ep, kv_dtype=None):
        eng = ep.engine
        return (eng.block_mgr.block_size * paged_kv_token_bytes(cfg, kv_dtype)
                * eng.n_attn_layers())

    def must_equal(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: {got} != {want}")

    # -- bf16: A (sanitized) and B behind one tier and one router
    tier = KVBlockStore(host_capacity_blocks=TIER_HOST_BLOCKS)
    a, b = replica(tier, True), replica(tier, False)
    block = block_bytes(a)
    must_equal("bf16 bytes a block", block, TIER_BLOCK_BYTES[None])
    router = Router("kv_affinity", kv_tier=tier)
    router.register("A", a)
    router.register("B", b)
    s = {}
    ops.reset_launch_counts()
    for n in ("P1", "P2"):                                     # 1.
        s[f"{n} cold"] = serve_one(torch, a, prompts[n], True)
        s[f"{n} warm"] = serve_one(torch, a, prompts[n], True)
    for i in range(1, TIER_CHURN + 1):                         # 2.
        s[f"C{i}"] = serve_one(torch, a, prompts[f"C{i}"], True)
    if not (tier.spills and tier.demotions):
        raise AssertionError(f"the churn spilled or demoted nothing: "
                             f"{tier.stats()}")
    s["P1 restored"] = serve_one(torch, a, prompts["P1"], True)   # 3.
    churn = [f"C{i}" for i in range(1, TIER_CHURN + 1)]
    hot = max(churn, key=lambda n: [
        tier.tier_of(h) for h in router.residency.chain_hashes(
            "A", prompts[n])].count("host"))
    routed = {}
    for n in ("P2", hot):                                      # 4., 5.
        d = router.route(prompts[n])
        routed[n] = d
        if d.name != "B":
            raise AssertionError(f"the router sent {n} to {d.name}: "
                                 f"{d}")
        s[f"{n} on B"] = serve_one(torch, b, prompts[n], False)
    counts = ops.launch_counts()
    for k in ("ragged_paged_attention", "paged_decode_attention"):
        if counts[k] <= 0:
            raise AssertionError(f"{k} never launched on the tier path")
    bodies = check_bodies(counts, "the tier path")
    by_tier = restores_by_tier(tier)
    if not (by_tier["host"] and by_tier["segment"]):
        raise AssertionError(f"restores by tier {by_tier}: want both")
    stats = check_tier_bytes("bf16", tier, block)
    must_equal("P1 restored vs warm", s["P1 restored"], s["P1 warm"])
    must_equal("P2 on B vs warm on A", s["P2 on B"], s["P2 warm"])
    must_equal(f"{hot} on B vs on A", s[f"{hot} on B"], s[hot])
    # 6. the sanitizer's and the checks' cost: the same request on A and
    # on B in turns, so that both see the same host
    turns = {"A": [], "B": []}
    for _ in range(TIER_TURNS):
        for name, ep, on in (("A", a, True), ("B", b, False)):
            serve_one(torch, ep, prompts["P2"], on, turns[name],
                      max_new=TIER_TURN_NEW)
    events = check_sanitizer("replica A", a)
    log(f"  bf16 tier: {stats}; restores by tier {by_tier}; launches "
        f"{counts}; A's sanitizer clean over {events} events")

    # -- int8: a fused replica with its own tier repeats 1-3
    tier8 = KVBlockStore(host_capacity_blocks=TIER_HOST_BLOCKS)
    q8 = replica(tier8, True, kv_dtype="int8", fused=True)
    block8 = block_bytes(q8, "int8")
    must_equal("int8 bytes a block", block8, TIER_BLOCK_BYTES["int8"])
    s8 = {}
    ops.reset_launch_counts()
    for n in ("P1", "P2"):
        s8[f"{n} cold"] = serve_one(torch, q8, prompts[n], True)
        s8[f"{n} warm"] = serve_one(torch, q8, prompts[n], True)
    for i in range(1, TIER_CHURN + 1):
        s8[f"C{i}"] = serve_one(torch, q8, prompts[f"C{i}"], True)
    s8["P1 restored"] = serve_one(torch, q8, prompts["P1"], True)
    counts8 = ops.launch_counts()
    if counts8["ragged_paged_attention_q8"] <= 0:
        raise AssertionError("the int8 ragged body never launched")
    bodies8 = check_bodies(counts8, "the int8 tier path")
    stats8 = check_tier_bytes("int8", tier8, block8)
    if not (tier8.spills and tier8.demotions and tier8.restores):
        raise AssertionError(f"int8 tier {stats8}")
    must_equal("int8 P1 restored vs warm", s8["P1 restored"], s8["P1 warm"])
    events8 = check_sanitizer("the int8 replica", q8)
    log(f"  int8 tier: {stats8}; restores by tier "
        f"{restores_by_tier(tier8)}; launches {counts8}; sanitizer clean "
        f"over {events8} events")
    serve_s = time.perf_counter() - t_phase

    cold_warm = {"bf16": {n: s[f"{n} cold"] == s[f"{n} warm"]
                          for n in ("P1", "P2")},
                 "int8": {n: s8[f"{n} cold"] == s8[f"{n} warm"]
                          for n in ("P1", "P2")}}
    decode = {k: step_stats(v)["decode_step_ms_p50"]
              for k, v in (("A in turns", turns["A"]),
                           ("B in turns", turns["B"]))}
    rec = {"block_bytes": {"bf16": block, "int8": block8},
           "tier_bf16": stats, "restores_by_tier_bf16": by_tier,
           "tier_int8": stats8,
           "restores_by_tier_int8": restores_by_tier(tier8),
           "launches": counts, "launches_int8": counts8,
           "bodies": bodies, "bodies_int8": bodies8,
           "sanitizer_events": {"A": events, "int8": events8},
           "sanitizer_findings": len(a.engine.sanitizer.findings)
           + len(q8.engine.sanitizer.findings),
           "restored_equals_warm": s["P1 restored"] == s["P1 warm"]
           and s8["P1 restored"] == s8["P1 warm"],
           "cold_equals_warm": cold_warm,
           "decode_step_ms_p50": decode,
           "router": router.stats(),
           "routed": {n: {"to": d.name, "warm_blocks": d.warm_blocks,
                          "restorable_blocks": d.restorable_blocks,
                          "score": d.score}
                      for n, d in routed.items()},
           "serve_s": serve_s,
           "page_rates": page_rates(torch, b.engine.runner, 16, block),
           "kernelcheck_cost": kernelcheck_cost(
               torch, cfg, b.engine.block_mgr.n_blocks)}
    log(f"  read_pages / write_pages of 16 blocks (wall, synchronised): "
        f"{rec['page_rates']['spill_GB_per_s']:.2f} GB/s card -> host, "
        f"{rec['page_rates']['restore_GB_per_s']:.2f} GB/s host -> card")
    log(f"  decode step p50 ms in turns on one request: A (sanitizer + "
        f"kernelcheck) {decode['A in turns']:.2f}, B (neither) "
        f"{decode['B in turns']:.2f} ({len(turns['A'])} and "
        f"{len(turns['B'])} steps); cold == warm: {cold_warm}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    log("TIER " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 8: the fleet control plane over real engines
# ---------------------------------------------------------------------------

FLEET_KEEPALIVE = 30.0      # the policy's idle window, simulated seconds
FLEET_HOST_BLOCKS = 64      # granite's KV host tier
FLEET_GRANITE_KW = dict(block_size=16, max_batch=4, max_seq=1024,
                        min_stages=2)
FLEET_RWKV_KW = dict(paged=False, max_batch=4, max_seq=1024)
FLEET_MEM_SLACK = 256 << 20  # allocated bytes the drain may leave behind


def prefix_witness(torch, model, params, prompt, cold, warm, block=16):
    """Where a prefix-cached stream (``warm``) leaves the cold one, the
    logits at the first diverging token from the prompt and the tokens both
    streams share: through one prefill of that whole context (the cold
    path's shape), and through a prefill of the prompt's full blocks (the
    cached prefix) followed by decode steps over the rest (another shape
    for the same suffix). Margins and shifts are in logits, over the real
    vocabulary. Reported, not asserted."""
    j = next((n for n, (x, y) in enumerate(zip(cold, warm)) if x != y),
             None)
    if j is None:
        return {"first_diverging": None}
    vocab = model.cfg.vocab
    dev = params["final_norm"].device
    ctx = torch.tensor([prompt + cold[:j]], dtype=torch.int32, device=dev)
    cached = len(prompt) // block * block
    la = model.prefill(params, ctx, 1024)[0][0, :vocab].float()
    lb, cache = model.prefill(params, ctx[:, :cached], 1024)
    for t in range(cached, ctx.shape[1]):
        pos = torch.tensor([[t]], dtype=torch.int32, device=dev)
        lb, cache = model.decode_step(params, cache, ctx[:, t:t + 1], pos)
    lb = lb[0, :vocab].float()
    top2 = la.topk(2).values
    return {"first_diverging": j, "of": len(cold), "cold_token": cold[j],
            "warm_token": warm[j], "prefill_argmax": int(la.argmax()),
            "prefix_then_decode_argmax": int(lb.argmax()),
            "top2_margin": float(top2[0] - top2[1]),
            "cold_gap": float(la[cold[j]] - la[warm[j]]),
            "logit_std": float(la.std()),
            "path_shift_max": float((la - lb).abs().max())}


def fleet_stores(torch):
    """granite-3-8b and rwkv6-1.6b at full width and depth, bf16, weights
    drawn once each from a seeded generator on the card: each chunked into
    a host-memory ``ModelStore`` behind the remote registry's bandwidth
    (the fleet's source tier), and served once on a 1-stage engine on the
    card (granite paged, rwkv slot-contiguous), each prompt alone as the
    fleet serves it. The card copy is freed before the fleet runs. Returns
    {name: (cfg, store)}, {name: 1-stage streams}, prompts, registration
    seconds."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine
    from repro_torch.store.store import ModelStore, REMOTE_BW

    granite, rwkv = get_config("granite-3-8b"), get_config("rwkv6-1.6b")
    g_prompts = main_prompts(granite.vocab)
    prompts = {"P1": g_prompts[0], "P2": g_prompts[1],        # 300, 257
               "R1": main_prompts(rwkv.vocab)[2]}              # 412
    stores, ref, reg_s = {}, {}, {}
    for cfg, names, paged in ((granite, ("P1", "P2"), True),
                              (rwkv, ("R1",), False)):
        model = Model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stores[cfg.name] = (cfg, ModelStore.from_params(model, params,
                                                        bandwidth=REMOTE_BW))
        reg_s[cfg.name] = time.perf_counter() - t0
        ep = ServingEndpoint(Engine(cfg, [params], paged=paged,
                                    block_size=16, device="cuda",
                                    **SERVE_KW))
        for n in names:
            ref[n] = serve_one(torch, ep, prompts[n], False, max_new=MAX_NEW)
        del ep, params
        gc.collect()
        torch.cuda.empty_cache()
    return stores, ref, prompts, reg_s


def fleet_phase(torch):
    """HydraServe's multi-model path on the card: one ``FleetFrontend`` over
    4 servers (16 Gbps NIC, 12 GB/s PCIe, 80 GB), the source tier at the
    remote registry's 2 Gbps, placements at the peer's 16 Gbps, the policy
    ``FleetPolicy(keepalive_s=30, proactive_placement=True,
    placement_interval_s=10, placement_top_k=2)``. granite-3-8b routed
    (``kv_affinity``, a 64-block KV host tier, paged, prefix cache, block
    16, 2-stage cold starts) and rwkv6-1.6b slot-contiguous, both full
    width and depth, bf16, greedy, 32 new tokens, on the simulated clock:

    1. t=0: granite P1 and P2 and rwkv R1; both cold starts begin in one
       pump and contend;
    2. granite's ready + 5 s: P1 again, warm, a prefix-cache hit;
    3. past the keepalive: placement rounds, the idle consolidation
       (through ``full_params``), the reap (granite's prefix cache spills
       to the host tier);
    4. P1 and R1 again, both cold, then drained to zero.

    Held: the first streams equal a 1-stage engine's on the same weights;
    the re-warmed R1 equals the first, the re-warmed P1 (restored prefix)
    the warm one; 4 cold starts, the second pair from the placement's tier
    and granite's second shorter; a consolidation; host blocks after the
    reap and a restore on the second P1; every slot empty after the drain and the card's allocated memory
    back within 256 MiB of its level before the first launch; ragged,
    paged decode and wkv6 launched, the attention kernels on their
    tensor-core bodies. Reported, not asserted: the warm and re-warmed P1
    against the cold one (as the tier phase holds cold against warm), with
    ``prefix_witness`` where they part. Returns the path's launch counts."""
    import gc
    from repro_torch.core import GB, Gbps, ServerSpec
    from repro_torch.fleet import FleetFrontend, FleetPolicy
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.serving.api import SamplingParams
    from repro_torch.store.store import PEER_BW, REMOTE_BW

    t_phase = time.perf_counter()
    stores, ref, prompts, reg_s = fleet_stores(torch)
    (G, (gcfg, gstore)), (R, (rcfg, rstore)) = stores.items()
    for name, (cfg, store) in stores.items():
        log(f"  {name}: {store.total_bytes / 2**30:.2f} GiB registered into "
            f"the host tier in {reg_s[name]:.1f} s")
    policy = FleetPolicy(keepalive_s=FLEET_KEEPALIVE,
                         proactive_placement=True, placement_interval_s=10.0,
                         placement_top_k=2)
    ff = FleetFrontend([ServerSpec(f"srv{i}", 16 * Gbps, 12e9, 80 * GB)
                        for i in range(4)], policy, source_bw=REMOTE_BW,
                       placement_bw=PEER_BW, device="cuda")
    ff.register(gcfg, profile_of(Model(gcfg)), store=gstore,
                routing="kv_affinity", kv_tier_blocks=FLEET_HOST_BLOCKS,
                **FLEET_GRANITE_KW)
    ff.register(rcfg, profile_of(Model(rcfg)), store=rstore, **FLEET_RWKV_KW)
    del gstore, rstore, stores

    # the wall time of every real load: each stage's materialize() and each
    # consolidation's full_params, the card synchronised around each
    loads = []
    front = ff.frontend
    begin, full = front.begin_cold_start, front.full_params

    def timed_begin(name, **kw):
        pend = begin(name, **kw)
        for i, st in enumerate(pend.stages):
            nbytes = front.store_of(name).stage_bytes(pend.n_stages, i)
            st.materialize = timed(torch, st.materialize, loads,
                                   (name, f"stage {i} of {pend.n_stages}",
                                    nbytes))
        return pend

    def timed_full(name, **kw):
        return timed(torch, full, loads,
                     (name, "full_params",
                      front.store_of(name).total_bytes))(name, **kw)

    front.begin_cold_start, front.full_params = timed_begin, timed_full

    sp = SamplingParams(max_new=MAX_NEW)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    p1, p2, r1 = ff.run_trace([(G, 0.0, prompts["P1"], sp),            # 1.
                               (G, 0.0, prompts["P2"], sp),
                               (R, 0.0, prompts["R1"], sp)])
    g_first = next(c for c in ff.cold_start_log if c["model"] == G)
    w1 = ff.submit(G, prompts["P1"], sp, now=g_first["ready"] + 5.0)  # 2.
    t = ff.now
    while any(mm.slots for mm in ff.models.values()):                 # 3.
        t += 1.0
        ff.advance(t)
    host_blocks = ff.models[G].kv_tier.host_blocks
    tier_after_reap = ff.models[G].kv_tier.stats()
    p1b, r1b = ff.run_trace([(G, t + 1.0, prompts["P1"], sp),         # 4.
                             (R, t + 1.0, prompts["R1"], sp)])
    t += 1.0
    while any(mm.slots for mm in ff.models.values()):
        t += 1.0
        ff.advance(t)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    counts = ops.launch_counts()
    gc.collect()
    mem_end = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    front.begin_cold_start, front.full_params = begin, full
    # every idle consolidation fetches the full weights once
    consolidations = sum(what == "full_params" for (_, what, _), _ in loads)

    def must(cond, what):
        if not cond:
            raise AssertionError(f"fleet: {what}")

    def first_diff(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None if len(a) == len(b) else min(len(a), len(b)))

    pairs = {"P1 first vs 1-stage": (p1.output, ref["P1"]),
             "P2 first vs 1-stage": (p2.output, ref["P2"]),
             "R1 first vs 1-stage": (r1.output, ref["R1"]),
             "P1 warm vs first": (w1.output, p1.output),
             "P1 re-warmed vs first": (p1b.output, p1.output),
             "P1 re-warmed vs warm": (p1b.output, w1.output),
             "R1 re-warmed vs first": (r1b.output, r1.output)}
    diverge = {k: first_diff(a, b) for k, (a, b) in pairs.items()}
    log(f"  streams, first diverging token (None: equal): {diverge}")
    # streams
    must(p1.output == ref["P1"] and p2.output == ref["P2"],
         "granite's first streams differ from a 1-stage paged engine's")
    must(r1.output == ref["R1"],
         "rwkv's first stream differs from a 1-stage contiguous engine's")
    # a restore after scale-to-zero gives what the warm replica gave: both
    # prefill only the suffix past the cached blocks, bit for bit the same
    # computation; the cold prefill computes those rows in a longer GEMM,
    # so a bf16 near-tie may part them (reported below, as the tier phase
    # reports cold against warm)
    must(p1b.output == w1.output, "the re-warmed granite P1 differs from "
         "the warm (prefix-cached) one")
    must(r1b.output == r1.output, "the re-warmed rwkv R1 differs from the "
         "first")
    must(all(len(r.output) == MAX_NEW for r in (p1, p2, r1, w1, p1b, r1b)),
         "a request was not served to its end")
    must(not w1.cold and w1.cached_tokens > 0,
         f"P1 at ready + 5 s was not a warm prefix hit: {w1}")
    # cold starts and placement
    log_ = ff.cold_start_log
    must(len(log_) == 4, f"{len(log_)} cold starts, want 4: {log_}")
    must(bool(ff.placement_log), "no placement round placed anything")
    first = {c["model"]: c for c in log_[:2]}
    second = {c["model"]: c for c in log_[2:]}
    must(set(first) == set(second) == {G, R}, f"cold starts {log_}")
    must(all(c["tier"] == policy.placement_tier for c in second.values()),
         f"the second pair did not fetch from {policy.placement_tier!r}: "
         f"{log_[2:]}")
    must(first[G]["s"] == 2, f"granite's cold start has {first[G]['s']} "
         f"stages, want 2")
    must(second[G]["duration"] < first[G]["duration"],
         "granite's second cold start is not shorter")
    must(consolidations >= 1, "no idle consolidation ran")
    # the KV tier
    must(host_blocks > 0, "the reap spilled nothing to the host tier")
    must(p1b.restored_tokens > 0, "the re-warmed P1 restored nothing")
    # the drain
    must(all(not mm.slots for mm in ff.models.values()), "slots left")
    must(mem_end - mem0 <= FLEET_MEM_SLACK,
         f"{(mem_end - mem0) / 2**20:.1f} MiB still allocated after the "
         f"drain")
    # kernels
    for k in ("ragged_paged_attention", "paged_decode_attention", "wkv6"):
        must(counts[k] > 0, f"{k} never launched on the fleet path")
    bodies = check_bodies(counts, "the fleet path")

    rates = [{"model": m, "load": what, "bytes": n, "seconds": s,
              "GB_per_s": n / s / 1e9} for (m, what, n), s in loads]
    for r in rates:
        log(f"  measured wall time of {r['model']} {r['load']} (host -> "
            f"card): {r['seconds']:.3f} s for {r['bytes'] / 2**30:.2f} GiB, "
            f"{r['GB_per_s']:.2f} GB/s")
    for c in log_:
        log(f"  cold start (simulated clock): {c['model']} t0 {c['t0']:.3f}"
            f" s, ready {c['ready']:.3f} s, {c['duration']:.3f} s, s="
            f"{c['s']}, tier {c['tier']}, servers {c['servers']}")
    witness = None
    if w1.output != p1.output:
        full = ff.frontend.full_params(G)
        witness = prefix_witness(torch, Model(gcfg), full, prompts["P1"],
                                 p1.output, w1.output)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  cold vs prefix-cached P1, first divergence: {witness}")
    metrics = ff.metrics()
    sim = {k: v for k, v in metrics.items() if k != "per_model"}
    log(f"  fleet metrics (simulated clock): {json.dumps(sim)}")
    cold_warm = w1.output == p1.output
    log(f"  warm P1 (prefix hit, {w1.cached_tokens} cached tokens) == cold "
        f"P1: {cold_warm} (reported); re-warmed P1 restored "
        f"{p1b.restored_tokens} tokens; {consolidations} consolidations; "
        f"host blocks after the reap {host_blocks}")
    log(f"  card memory: {mem0 / 2**30:.2f} GiB before the first launch, "
        f"peak {peak / 2**30:.2f} GiB, {mem_end / 2**30:.2f} GiB after the "
        f"drain; launches {counts}; fleet run {run_s:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    rec = {"loads_measured": rates, "cold_starts_simulated": log_,
           "placements_simulated": ff.placement_log,
           "metrics_simulated": sim,
           "requests_simulated": [
               {"model": r.model, "arrival": r.arrival, "wait": r.wait,
                "ttft": r.ttft, "cold": r.cold, "cached_tokens":
                r.cached_tokens, "restored_tokens": r.restored_tokens,
                "restore_seconds": r.restore_seconds}
               for r in (p1, p2, r1, w1, p1b, r1b)],
           "kv_tier_after_reap": tier_after_reap,
           "kv_tier_end": ff.models[G].kv_tier.stats(),
           "router": ff.models[G].router.stats(),
           "consolidations": consolidations, "cold_equals_warm": cold_warm,
           "stream_divergence": diverge, "prefix_witness": witness,
           "memory": {"before": mem0, "peak": peak, "after": mem_end},
           "registration_s": reg_s, "launches": counts, "bodies": bodies,
           "run_s": run_s, "phase_s": time.perf_counter() - t_phase}
    log("FLEET " + json.dumps(rec))
    return {k: counts[k] for k in ("ragged_paged_attention",
                                   "paged_decode_attention", "wkv6")}


# ---------------------------------------------------------------------------
# phase 9: sparse experts and Mamba (qwen2-moe-a2.7b, jamba-v0.1-52b)
# ---------------------------------------------------------------------------

G1_HEADS = 16             # qwen2-moe-a2.7b: 16 q and 16 kv heads (group 1)
JAMBA_LAYERS = 16         # two periods of 8 (48.64 GiB; 32 do not fit)
FAM_KW = dict(max_batch=4, max_seq=1024, block_size=16, device="cuda")


def g1_kernel_phase(torch, reps, flush):
    """The four attention kernels at qwen2-moe-a2.7b's geometry (GQA group
    1: Hq = Hkv = 16, hd 128, bf16, page 16), each launched once on its
    tensor-core body (``ops.body_counts``) and held row by row against its
    float32 plain version, then timed beside its bound, its plain version
    and one library call, at the kernel phase's shapes: the mixed ragged
    batch, decode at kv_len 1,024/777/300/1 (paged, table of 65 pages; and
    contiguous, S 1,024) and flash at Sq = Sk = 412. Printed as ``G1``;
    returns one row a kernel."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ragged_attention as kra
    h = G1_HEADS
    g = torch.Generator(device="cuda").manual_seed(21)
    lens = [1024, 777, 300, 1]
    kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = {}

    def one(name, label, fn, plain, library, nbytes, flops):
        ops.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        bodies = ops.body_counts()
        if (bodies[f"{name}/tensor_core"], bodies[f"{name}/cuda_core"]) \
                != (1, 0):
            raise AssertionError(f"G=1 {name}: not on the tensor cores "
                                 f"({bodies})")
        err = check_rows(f"G=1 {label}", got, plain(True))
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        rows[name] = dict(
            **kernel_ms(torch, fn, reps, flush),
            plain_ms=time_ms(torch, lambda: plain(False), max(3, reps // 4),
                             1, flush),
            library_ms=time_ms(torch, library, reps, flush=flush),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
            err_over_tol=err[1])

    q, k, v, tb, row, pos = ragged_batch(torch, h, h, HD, BS,
                                         torch.bfloat16, 21)
    k, v = k.bfloat16(), v.bfloat16()
    one("ragged_paged_attention", "ragged bf16 pages",
        lambda: kra.ragged_paged_attention(q, k, v, tb, row, pos),
        lambda f32: ref.ragged_paged_attention_reference(
            q.float() if f32 else q, k.float() if f32 else k,
            v.float() if f32 else v, tb, row, pos),
        sdpa_ragged(torch, q, k, v, tb, row, pos),
        *ragged_cost(q, 2 * h * HD * 2, tb, row, pos, h, HD))
    rows["ragged_paged_attention"].update(ragged_stats(
        torch, lambda: kra.ragged_paged_attention(q, k, v, tb, row, pos)))
    log(ragged_line("G=1 ragged bf16 pages", rows["ragged_paged_attention"]))

    nb = ENGINE_TABLE
    n_pages = len(lens) * nb + 1
    tbd = torch.randperm(n_pages - 1, generator=g, device="cuda").reshape(
        len(lens), nb).to(torch.int32)
    kp, vp = (torch.randn((n_pages, BS, h, HD), generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    qd = torch.randn((len(lens), 1, h, HD), generator=g,
                     device="cuda").bfloat16()
    dec_bytes = (sum(lens) * 2 * h * HD * 2 + 2 * qd.numel() * 2
                 + kl.numel() * 4)
    dec_flops = sum(4 * h * HD * n for n in lens)
    one("paged_decode_attention", "paged decode bf16 pages",
        lambda: kda.paged_decode_attention(qd, kp, vp, tbd, kl),
        lambda f32: ref.paged_decode_attention_reference(
            qd.float() if f32 else qd, kp.float() if f32 else kp,
            vp.float() if f32 else vp, tbd, kl),
        sdpa_decode(torch, qd, kp, vp, tbd, kl),
        dec_bytes + tbd.numel() * 4, dec_flops)
    rows["paged_decode_attention"].update(decode_stats(
        torch, "paged_decode_attention",
        lambda: kda.paged_decode_attention(qd, kp, vp, tbd, kl)))

    qf, kf, vf = (torch.randn((1, 412, h, HD), generator=g, device="cuda")
                  .bfloat16() for _ in range(3))
    one("flash_attention", "flash bf16 Sq=Sk=412",
        lambda: kfa.flash_attention(qf, kf, vf),
        lambda f32: ref.mha_reference(*(a.float() if f32 else a
                                        for a in (qf, kf, vf))),
        sdpa_flash(torch, qf, kf, vf),
        2 * (2 * qf.numel() + kf.numel() + vf.numel()),
        4 * h * HD * 412 * 413 // 2)
    rows["flash_attention"].update(flash_stats(
        torch, lambda: kfa.flash_attention(qf, kf, vf),
        4 * h * HD * 412 * 413 // 2,
        rows["flash_attention"]["ms"]))

    kc, vc = (torch.randn((len(lens), ENGINE_S, h, HD), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    one("decode_attention", "contiguous decode bf16 caches",
        lambda: kda.decode_attention(qd, kc, vc, kl),
        lambda f32: ref.decode_attention_reference(
            *(a.float() if f32 else a for a in (qd, kc, vc)), kl),
        sdpa_contig_decode(torch, qd, kc, vc, kl), dec_bytes, dec_flops)
    rows["decode_attention"].update(decode_stats(
        torch, "decode_attention",
        lambda: kda.decode_attention(qd, kc, vc, kl)))
    for name, r in rows.items():
        tile = (f", tile {r['tile_rows']} rows, {r['tflops']:.1f} TFLOP/s"
                if "tflops" in r else
                f", {r['body']} body, span tile {r['tile_rows']} rows"
                if "body" in r else
                f", clusters of {r['cluster']}, partials in "
                f"{r['partials']}" if "cluster" in r else "")
        log(f"  G=1 {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms; without the hold "
            f"{r['ms_host_gap']:.4f} ms{tile})")
    log("G1 " + json.dumps(rows))
    return rows


def family_params(torch, name, n_layers=None):
    """Full-width ``name`` (depth cut to ``n_layers`` where given) on random
    bf16 weights from a seeded generator on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    info = {"layers": cfg.n_layers, "of": get_config(name).n_layers,
            "bytes": model.bytes(), "draw_s": time.perf_counter() - t0,
            "allocated_gib": torch.cuda.memory_allocated() / 2**30}
    log(f"  {name}: {cfg.n_layers} of {info['of']} layers, d "
        f"{cfg.d_model}, {model.bytes() / 2**30:.2f} GiB of bf16 weights, "
        f"drawn in {info['draw_s']:.1f} s; {info['allocated_gib']:.2f} GiB "
        f"on the card")
    return cfg, model, params, info


def family_path(torch, label, ep, prompts, expect, absent=(),
                consolidate=None, prefixes=None):
    """Serve ``prompts`` through ``ep`` with every launch counted from 0,
    consolidating after 4 tokens where ``consolidate`` is given, with 4
    decode steps from step ``PROFILE_AT`` profiled. Every kernel in
    ``expect`` must have launched, none in ``absent``, each attention
    launch on the tensor cores. Returns (streams, launches, bodies, the
    step statistics with the profiled device ms a decode step and the
    device's busy share of the unprofiled decode-step p50)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    streams, steps, prof = drive(
        torch, ep, prompts, consolidate_after=4 if consolidate else None,
        consolidate=consolidate, profile_at=PROFILE_AT, prefixes=prefixes)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if consolidate is not None and ep.n_stages != 1:
        raise AssertionError(f"{label}: not consolidated")
    for k in expect:
        if counts[k] <= 0:
            raise AssertionError(f"{label}: {k} never launched ({counts})")
    for k in absent:
        if counts[k] != 0:
            raise AssertionError(f"{label}: {k} launched ({counts})")
    bodies = check_bodies(counts, label)
    vocab = ep.engine.cfg.vocab
    if not all(len(s) == MAX_NEW and all(0 <= t < vocab for t in s)
               for s in streams):
        raise AssertionError(f"{label}: bad streams {streams}")
    if prof is None:
        raise AssertionError(f"{label}: nothing profiled")
    stats = step_stats(steps)
    stats["device_ms_per_decode_step"] = prof["device_ms_per_step"]
    stats["busy"] = prof["device_ms_per_step"] / stats["decode_step_ms_p50"]
    stats["top_kernels_ms_per_step"] = prof["top_kernels_ms_per_step"]
    log(f"  {label}: prefill {stats['prefill_tok_s']:.1f} tok/s, decode "
        f"{stats['decode_tok_s']:.1f} tok/s, decode step p50 "
        f"{stats['decode_step_ms_p50']:.2f} ms p99 "
        f"{stats['decode_step_ms_p99']:.2f} ms, device "
        f"{stats['device_ms_per_decode_step']:.2f} ms a decode step (busy "
        f"{stats['busy']:.3f}), {stats['steps']} steps; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    return streams, counts, bodies, stats


def _dev_ms(e):
    """A profiler event's device time in µs (``cuda_time_total`` before
    PyTorch named it ``device_time_total``)."""
    if hasattr(e, "device_time_total"):
        return e.device_time_total
    return e.cuda_time_total


def family_prefill_profile(torch, model, params, prompt, layouts):
    """One forward of ``prompt`` through ``Model.prefill`` on each layout
    under ``torch.profiler``, after one warm-up forward, with the MoE MLP,
    the dense MLP (the shared experts inside the MoE) and the Mamba scan
    marked by ``record_function`` wrappers installed for the profiled call
    only. Returns, per layout, the forward's device ms (all kernels; one
    stream), the attention kernel's, the MoE MLP's and, inside it, the
    expert products' (its ``einsum``s over the capacity buffer), the shared
    experts' and the dispatch's (the rest: router, sort, scatter, combine),
    the Mamba scan's, and the expert buffer's FLOPs over the active rows'."""
    from unittest import mock
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import mlp as mlp_mod

    def marked(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    def under(e, name):
        p = e.cpu_parent
        while p is not None:
            if p.name == name:
                return True
            p = p.cpu_parent
        return False

    cfg = model.cfg
    tokens = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    res = {}
    for label, kw, names, rows in layouts:
        model.prefill(params, tokens, 1024, **kw)
        torch.cuda.synchronize()
        with mock.patch.object(mlp_mod, "moe_mlp",
                               marked("fam::moe", mlp_mod.moe_mlp)), \
                mock.patch.object(mlp_mod, "dense_mlp",
                                  marked("fam::dense", mlp_mod.dense_mlp)), \
                mock.patch.object(mamba_mod, "_scan",
                                  marked("fam::scan", mamba_mod._scan)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.prefill(params, tokens, 1024, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        kern = {e.key: e.device_time_total / 1e3
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith("fam::")}
        total = sum(kern.values())
        attn = sum(v for k, v in kern.items()
                   if any(f"::{n}<" in k for n in names))
        cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        moe = sum(_dev_ms(e) for e in cpu if e.name == "fam::moe") / 1e3
        experts = sum(_dev_ms(e) for e in cpu if e.name == "aten::einsum"
                      and under(e, "fam::moe")) / 1e3
        shared = sum(_dev_ms(e) for e in cpu if e.name == "fam::dense"
                     and under(e, "fam::moe")) / 1e3
        scan = sum(_dev_ms(e) for e in cpu if e.name == "fam::scan") / 1e3
        rec = {"tokens": len(prompt), "device_ms": total,
               "attention_kernel_ms": attn, "moe_ms": moe,
               "expert_products_ms": experts, "shared_experts_ms": shared,
               "moe_dispatch_ms": moe - experts - shared,
               "mamba_scan_ms": scan, "profiled_wall_ms": wall * 1e3}
        for key in ("attention_kernel", "moe", "expert_products",
                    "moe_dispatch", "mamba_scan"):
            rec[f"{key}_share"] = rec[f"{key}_ms"] / total if total else None
        if cfg.n_experts:
            # rows of x the MoE routes (pads of the ragged step included)
            groups = mlp_mod.moe_groups(rows)
            cap = mlp_mod.moe_capacity(cfg, rows // groups * cfg.top_k)
            rec["moe_rows"] = rows
            rec["moe_groups"] = groups
            rec["moe_capacity"] = cap
            rec["expert_buffer_over_active_flops"] = (
                groups * cfg.n_experts * cap / (rows * cfg.top_k))
        rec["top_kernels_ms"] = {k[:60]: v for k, v in sorted(
            kern.items(), key=lambda kv: -kv[1])[:5]}
        if not (total > 0 and attn > 0):
            raise AssertionError(f"{label}: no attention kernel time")
        res[label] = rec
        log(f"  prefill of {len(prompt)} tokens, {label}: device "
            f"{total:.3f} ms; attention {attn:.3f} ms, MoE {moe:.3f} ms "
            f"(experts {experts:.3f}, shared {shared:.3f}, dispatch "
            f"{moe - experts - shared:.3f}), Mamba scan {scan:.3f} ms; "
            f"profiled wall {wall * 1e3:.1f} ms")
    return res


def decode_layout_witness(torch, model, params, prompts, streams,
                          pg_streams):
    """Where a request's slot-contiguous stream leaves its paged stream, the
    logits at the first diverging token on each layout, from a prefill of
    the prompt and decode steps over the tokens both streams share (a
    hybrid's prefill is the same on both layouts: its streams part in
    decode, where the two decode kernels sum in another order). Returns one
    record per request; margins and shifts are in logits, over the real
    vocabulary."""
    vocab = model.cfg.vocab
    dev = params["final_norm"].device
    records = []
    for i, (p, a, b) in enumerate(zip(prompts, streams, pg_streams)):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            records.append({"request": i, "first_diverging": None})
            continue
        out = []
        for paged in (False, True):
            lg, cache = model.prefill(
                params, torch.tensor([p], dtype=torch.int32, device=dev),
                1024, paged=paged)
            for n, tok in enumerate(a[:j]):
                lg, cache = model.decode_step(
                    params, cache,
                    torch.tensor([[tok]], dtype=torch.int32, device=dev),
                    torch.tensor([[len(p) + n]], dtype=torch.int32,
                                 device=dev))
            out.append(lg[0, :vocab].float())
        lc, lp = out
        top2 = lc.topk(2).values
        records.append({
            "request": i, "first_diverging": j, "of": len(a),
            "contiguous_token": a[j], "paged_token": b[j],
            "replay_argmax_contiguous": int(lc.argmax()),
            "replay_argmax_paged": int(lp.argmax()),
            "contiguous_top2_margin": float(top2[0] - top2[1]),
            "contiguous_gap": float(lc[a[j]] - lc[b[j]]),
            "logit_std": float(lc.std()),
            "layout_shift_max": float((lc - lp).abs().max()),
        })
    return records


def composition_witness(torch, model, params, prompts, streams, other):
    """Where a request's stream from another step composition (``other``:
    the fused engine's) leaves its 1-stage paged stream, the logits at the
    first parting token from a ragged prefill of the prompt and the tokens
    both streams share, alone and beside a copy of itself (twice the rows:
    other groups and GEMM shapes, still no drop). Returns one record per
    request: the top-2 margin alone beside how far the composition moves
    the logits, over the real vocabulary. Reported, not asserted."""
    vocab = model.cfg.vocab
    dev = params["final_norm"].device
    records = []
    for i, (p, a, b) in enumerate(zip(prompts, streams, other)):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            records.append({"request": i, "first_diverging": None})
            continue
        ctx = torch.tensor([p + a[:j]], dtype=torch.int32, device=dev)
        alone = model.prefill(params, ctx, 1024)[0][0, :vocab].float()
        pair = model.prefill(params, ctx.repeat(2, 1), 1024)[0][0, :vocab]
        pair = pair.float()
        top2 = alone.topk(2).values
        records.append({
            "request": i, "first_diverging": j, "of": len(a),
            "paged_token": a[j], "other_token": b[j],
            "argmax_alone": int(alone.argmax()),
            "argmax_beside_a_copy": int(pair.argmax()),
            "top2_margin": float(top2[0] - top2[1]),
            "paged_gap": float(alone[a[j]] - alone[b[j]]),
            "logit_std": float(alone.std()),
            "composition_shift_max": float((alone - pair).abs().max()),
        })
    return records


def agreement(a, b):
    """The share of tokens on which streams ``a`` and ``b`` agree, and the
    index of each request's first parting token (None where none)."""
    share = sum(x == y for s, r in zip(a, b) for x, y in zip(s, r)) \
        / sum(len(s) for s in a)
    parting = [next((n for n, (x, y) in enumerate(zip(s, r)) if x != y),
                    None) for s, r in zip(a, b)]
    return share, parting


def moe_family(torch, prompts):
    """qwen2-moe-a2.7b at full width and depth (24 layers, d 2048, 16 q and
    16 kv heads of 128, 60 routed experts top-4 plus 4 shared of d_ff 1408,
    padded vocab 152064): a 2-stage paged endpoint (ragged prefill, chunks
    of 256) consolidated after 4 tokens against a 1-stage one (streams
    equal), then a fused engine over bf16 pages, one over int8 pages and a
    contiguous engine, each path's launches counted from 0; last one
    profiled 412-token prefill on each layout."""
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine
    cfg, model, params, info = family_params(torch, "qwen2-moe-a2.7b")
    kw = dict(FAM_KW, paged=True, prefill_chunk=256)
    paths, launches, bodies, streams = {}, {}, {}, {}

    def run(label, ep, expect, absent=(), consolidate=None):
        s, c, b, st = family_path(torch, label, ep, prompts, expect, absent,
                                  consolidate)
        paths[label], launches[label], bodies[label] = st, c, b
        streams[label] = s
        return s

    stages = [model.slice_stage_params(params, 2, i) for i in range(2)]
    ep = ServingEndpoint(Engine(cfg, stages, **kw))
    main = run("qwen2-moe 2-stage -> consolidated, paged", ep,
               ("ragged_paged_attention", "paged_decode_attention"),
               ("flash_attention", "decode_attention"),
               consolidate=lambda: ep.consolidate(params))
    del ep, stages
    one = run("qwen2-moe 1-stage, paged",
              ServingEndpoint(Engine(cfg, [params], **kw)),
              ("ragged_paged_attention", "paged_decode_attention"))
    if main != one:
        raise AssertionError(f"qwen2-moe: 2-stage + consolidation streams "
                             f"differ from the 1-stage engine's:\n{main}\n"
                             f"{one}")
    log("  streams: qwen2-moe 2-stage + consolidation == 1-stage (paged)")
    run("qwen2-moe 1-stage fused, bf16 pages",
        ServingEndpoint(Engine(cfg, [params], fused=True, **kw)),
        ("ragged_paged_attention",), ("paged_decode_attention",))
    run("qwen2-moe 1-stage fused, int8 pages",
        ServingEndpoint(Engine(cfg, [params], fused=True, kv_dtype="int8",
                               **kw)),
        ("ragged_paged_attention_q8",), ("paged_decode_attention",))
    run("qwen2-moe 1-stage, contiguous",
        ServingEndpoint(Engine(cfg, [params], **dict(FAM_KW, paged=False))),
        ("flash_attention", "decode_attention"),
        ("ragged_paged_attention", "paged_decode_attention"))
    agree = {label: agreement(s, one) for label, s in streams.items()}
    log(f"  qwen2-moe token agreement with the 1-stage paged streams (share,"
        f" first parting token of each request): {agree}")
    witness = composition_witness(
        torch, model, params, prompts, one,
        streams["qwen2-moe 1-stage fused, bf16 pages"])
    for w in witness:
        log(f"  qwen2-moe fused vs paged stream, first divergence: {w}")
    prefill = family_prefill_profile(torch, model, params, prompts[2], (
        ("contiguous (flash)", dict(paged=False),
         ("flash_wgmma_kernel", "flash_kernel"), 412),
        ("paged (ragged)", dict(paged=True),
         ("ragged_split_kernel", "ragged_combine_kernel", "ragged_span_kernel",
          "ragged_kernel"), 416)))
    return {"model": info, "paths": paths, "launches": launches,
            "bodies": bodies, "agreement_with_paged": agree,
            "fused_composition_witness": witness,
            "prefill_profile": prefill}


def jamba_family(torch, prompts):
    """jamba-v0.1-52b at full width, cut to 16 of its 32 layers (attention
    at 2, Mamba at 14 with d_in 8192, state 16, conv 4; MoE of 16 experts
    top-2 at d_ff 14336 on 8): a 2-stage paged endpoint (each prefill
    writes its K/V into the pools through flash, decode over the pages)
    consolidated after 4 tokens with the Mamba states migrated, against a
    1-stage paged engine (streams equal), then a contiguous engine (where
    its streams part from the paged ones, the parting token must be a
    near-tie); last one profiled 412-token prefill on each layout."""
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine
    cfg, model, params, info = family_params(torch, "jamba-v0.1-52b",
                                             JAMBA_LAYERS)
    d_in = cfg.mamba_expand * cfg.d_model
    n_mamba = cfg.mixer_pattern.count("mamba") * cfg.n_periods
    info["mamba_state_bytes_per_slot"] = n_mamba * (
        (cfg.mamba_d_conv - 1) * d_in * 2 + d_in * cfg.mamba_d_state * 4)
    kw = dict(FAM_KW, paged=True)
    paths, launches, bodies = {}, {}, {}

    def run(label, ep, expect, absent=(), consolidate=None):
        s, c, b, st = family_path(torch, label, ep, prompts, expect, absent,
                                  consolidate)
        paths[label], launches[label], bodies[label] = st, c, b
        return s

    stages = [model.slice_stage_params(params, 2, i) for i in range(2)]
    ep = ServingEndpoint(Engine(cfg, stages, **kw))
    main = run("jamba 2-stage -> consolidated, paged", ep,
               ("flash_attention", "paged_decode_attention"),
               ("ragged_paged_attention", "decode_attention"),
               consolidate=lambda: ep.consolidate(params))
    del ep, stages
    one = run("jamba 1-stage, paged",
              ServingEndpoint(Engine(cfg, [params], **kw)),
              ("flash_attention", "paged_decode_attention"),
              ("ragged_paged_attention", "decode_attention"))
    if main != one:
        raise AssertionError(f"jamba: 2-stage + consolidation streams "
                             f"differ from the 1-stage engine's:\n{main}\n"
                             f"{one}")
    log("  streams: jamba 2-stage + consolidation == 1-stage (paged)")
    contiguous = run("jamba 1-stage, contiguous",
                     ServingEndpoint(Engine(cfg, [params],
                                            **dict(FAM_KW, paged=False))),
                     ("flash_attention", "decode_attention"),
                     ("ragged_paged_attention", "paged_decode_attention"))
    agree, _ = agreement(contiguous, one)
    witness = decode_layout_witness(torch, model, params, prompts,
                                    contiguous, one)
    for w in witness:
        log(f"  jamba contiguous vs paged stream, first divergence: {w}")
        if w["first_diverging"] is not None and \
                not w["contiguous_top2_margin"] <= w["layout_shift_max"]:
            raise AssertionError(f"jamba request {w['request']}: the layouts "
                                 f"part where the layout cannot flip the "
                                 f"choice")
    log(f"  jamba contiguous streams agree with paged on {agree:.3f} of "
        f"tokens")
    prefill = family_prefill_profile(torch, model, params, prompts[2], (
        ("contiguous (flash)", dict(paged=False),
         ("flash_wgmma_kernel", "flash_kernel"), 412),
        ("paged (flash over the pools)", dict(paged=True),
         ("flash_wgmma_kernel", "flash_kernel"), 412)))
    return {"model": info, "paths": paths, "launches": launches,
            "bodies": bodies, "contiguous_agreement": agree,
            "layout_witness": witness, "prefill_profile": prefill}


FAMILIES_TITLE = ("== sparse experts and Mamba: qwen2-moe-a2.7b (full width "
                  "and depth) and jamba-v0.1-52b (full width, 16 layers)")


def families_phase(torch):
    """The ``FAMILIES`` phase: the attention kernels at GQA group 1, then
    qwen2-moe-a2.7b (full width and depth) and jamba-v0.1-52b (full width,
    16 layers), one after the other, the first freed before the second is
    drawn. Returns every kernel's launches over the phase's paths."""
    import gc
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    g1 = g1_kernel_phase(torch, 20, flush)
    del flush
    prompts = main_prompts(get_config("qwen2-moe-a2.7b").vocab)
    t0 = time.perf_counter()
    qwen = moe_family(torch, prompts)
    qwen["phase_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    prompts = main_prompts(get_config("jamba-v0.1-52b").vocab)
    t0 = time.perf_counter()
    jamba = jamba_family(torch, prompts)
    jamba["phase_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    total = {}
    for fam in (qwen, jamba):
        for counts in fam["launches"].values():
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
    rec = {"g1": g1, "qwen2-moe-a2.7b": qwen, "jamba-v0.1-52b": jamba,
           "launches": total, "phase_s": time.perf_counter() - t_phase}
    log(f"  FAMILIES phase: {rec['phase_s']:.1f} s (qwen2-moe "
        f"{qwen['phase_s']:.1f} s, jamba {jamba['phase_s']:.1f} s)")
    log("FAMILIES " + json.dumps(rec))
    return total, g1


# ---------------------------------------------------------------------------
# phase 10: whisper-small's encoder-decoder and llava-next-34b's image
# prefixes (ENCDEC_VLM)
# ---------------------------------------------------------------------------

WHISPER_MAX_SEQ = 448     # whisper's decoder context (448 positions)
ENCDEC_REL = 2.0 ** -5    # bf16 decode logits vs one full forward, of max
VLM_TEXT_ONLY = 3         # llava's request without an image (190 tokens)
VLM_IMAGE_ROWS = 576      # llava's image prefix rows (n_image_tokens)
ENCDEC_VLM_TITLE = ("== encoder-decoder and image prefixes: whisper-small "
                    "and llava-next-34b (full width and depth)")


def flash_pairs(b, sq, sk, causal):
    """(query, key) pairs flash attends: a causal row t sees min(t+1, Sk)
    keys."""
    if not causal:
        return b * sq * sk
    return b * sum(min(t + 1, sk) for t in range(sq))


def encdec_vlm_kernel_phase(torch, reps, flush):
    """The four attention kernels at whisper-small's shapes (hd 64, Hq =
    Hkv = 12: the non-causal encoder over 1,500 frames at batch 1, the
    path's, and 4; the causal decoder prefill of 412 tokens;
    cross-attention of 412 rows and of one row a request at batch 4 over
    the 1,500 frames; contiguous decode at batch 4, S 448, kv_len
    316/273/428/206) and llava-next-34b's (Hq 56 over Hkv 8, hd 128, GQA
    group 7: the 988-row prefix prefill; paged and contiguous decode at
    kv_len 892/849/1,004/206 under a table of 65 pages and S 1,024; the
    ragged kernel's mixed batch over bf16 and int8 pages), each launched
    once on its tensor-core body (``ops.body_counts``) and held row by row
    against its float32 plain version, then timed beside its bound, its
    plain version and one library call. Printed as ``ENCDEC_VLM_KERNELS``;
    returns {label: row}."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ragged_attention as kra
    g = torch.Generator(device="cuda").manual_seed(31)
    rows = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    def one(label, name, fn, plain, library, nbytes, flops):
        ops.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        bodies = ops.body_counts()
        if (bodies[f"{name}/tensor_core"], bodies[f"{name}/cuda_core"]) \
                != (1, 0):
            raise AssertionError(f"{label}: not on the tensor cores "
                                 f"({bodies})")
        err = check_rows(label, got, plain(True))
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        rows[label] = dict(
            kernel=name, **kernel_ms(torch, fn, reps, flush),
            plain_ms=time_ms(torch, lambda: plain(False), max(3, reps // 4),
                             1, flush),
            library_ms=time_ms(torch, library, reps, flush=flush),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
            err_over_tol=err[1])

    def flash(label, b, sq, sk, hq, hkv, hd, causal):
        q, k, v = randn(b, sq, hq, hd), randn(b, sk, hkv, hd), \
            randn(b, sk, hkv, hd)
        one(label, "flash_attention",
            lambda: kfa.flash_attention(q, k, v, causal=causal),
            lambda f32: ref.mha_reference(
                *(a.float() if f32 else a for a in (q, k, v)), causal=causal),
            sdpa_flash(torch, q, k, v, causal),
            2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * hq * hd * flash_pairs(b, sq, sk, causal))
        rows[label].update(flash_stats(
            torch, lambda: kfa.flash_attention(q, k, v, causal=causal),
            4 * hq * hd * flash_pairs(b, sq, sk, causal),
            rows[label]["ms"]))
        log(f"  {label}: flash {rows[label]['ms']:.4f} ms, tile "
            f"{rows[label]['tile_rows']} rows, "
            f"{rows[label]['tflops']:.1f} TFLOP/s")

    def decode(prefix, lens, hq, hkv, hd, s, paged):
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        qd = randn(len(lens), 1, hq, hd)
        nbytes = (sum(lens) * 2 * hkv * hd * 2 + 2 * qd.numel() * 2
                  + kl.numel() * 4)
        flops = sum(4 * hq * hd * n for n in lens)
        if not paged:
            kc, vc = randn(len(lens), s, hkv, hd), randn(len(lens), s, hkv,
                                                         hd)
            one(f"{prefix} contiguous decode", "decode_attention",
                lambda: kda.decode_attention(qd, kc, vc, kl),
                lambda f32: ref.decode_attention_reference(
                    *(a.float() if f32 else a for a in (qd, kc, vc)), kl),
                sdpa_contig_decode(torch, qd, kc, vc, kl), nbytes, flops)
            return
        nb = s // BS + 1
        n_pages = len(lens) * nb + 1
        tb = torch.randperm(n_pages - 1, generator=g, device="cuda").reshape(
            len(lens), nb).to(torch.int32)
        kp, vp = randn(n_pages, BS, hkv, hd), randn(n_pages, BS, hkv, hd)
        one(f"{prefix} paged decode", "paged_decode_attention",
            lambda: kda.paged_decode_attention(qd, kp, vp, tb, kl),
            lambda f32: ref.paged_decode_attention_reference(
                *(a.float() if f32 else a for a in (qd, kp, vp)), tb, kl),
            sdpa_decode(torch, qd, kp, vp, tb, kl),
            nbytes + tb.numel() * 4, flops)

    wh = (12, 12, 64)
    lv = (56, 8, 128)
    flash("whisper encoder B1", 1, 1500, 1500, *wh, False)
    flash("whisper encoder B4", 4, 1500, 1500, *wh, False)
    flash("whisper decoder prefill", 1, 412, 412, *wh, True)
    flash("whisper cross prefill", 1, 412, 1500, *wh, False)
    flash("whisper cross decode", 4, 1, 1500, *wh, False)
    decode("whisper", [316, 273, 428, 206], *wh, WHISPER_MAX_SEQ, False)
    flash("llava prefix prefill", 1, VLM_IMAGE_ROWS + 412,
          VLM_IMAGE_ROWS + 412, *lv, True)
    lens = [VLM_IMAGE_ROWS + n + 16 for n in (300, 257, 412)] + [190 + 16]
    decode("llava", lens, *lv, ENGINE_S, False)
    decode("llava", lens, *lv, ENGINE_S, True)

    q, k32, v32, tb, row, pos = ragged_batch(torch, *lv[:2], lv[2], BS,
                                             torch.bfloat16, 32)
    k, v = k32.bfloat16(), v32.bfloat16()
    one("llava ragged bf16 pages", "ragged_paged_attention",
        lambda: kra.ragged_paged_attention(q, k, v, tb, row, pos),
        lambda f32: ref.ragged_paged_attention_reference(
            q.float() if f32 else q, k.float() if f32 else k,
            v.float() if f32 else v, tb, row, pos),
        sdpa_ragged(torch, q, k, v, tb, row, pos),
        *ragged_cost(q, 2 * lv[1] * lv[2] * 2, tb, row, pos, lv[1], lv[2]))
    if not bool((kra.ragged_paged_attention(q, k, v, tb, row, pos)[pos < 0]
                 == 0).all()):
        raise AssertionError("llava ragged: pad rows are not exactly 0")
    kq, ks, kz = ref.quantize_kv(k32)
    vq, vs, vz = ref.quantize_kv(v32)
    quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
    one("llava ragged int8 pages", "ragged_paged_attention_q8",
        lambda: kra.ragged_paged_attention(q, kq, vq, tb, row, pos,
                                           kv_quant=quant),
        lambda f32: ref.ragged_paged_attention_reference(
            q.float() if f32 else q, kq, vq, tb, row, pos, kv_quant=quant),
        sdpa_ragged(torch, q, ref.dequantize_kv(kq, ks, kz).bfloat16(),
                    ref.dequantize_kv(vq, vs, vz).bfloat16(), tb, row, pos),
        *ragged_cost(q, 2 * lv[1] * lv[2] + 4 * lv[1] * 4, tb, row, pos,
                     lv[1], lv[2]))
    rows["llava ragged bf16 pages"].update(ragged_stats(
        torch, lambda: kra.ragged_paged_attention(q, k, v, tb, row, pos)))
    rows["llava ragged int8 pages"].update(ragged_stats(
        torch, lambda: kra.ragged_paged_attention(q, kq, vq, tb, row, pos,
                                                  kv_quant=quant)))
    for label, r in rows.items():
        if "body" in r:
            log(ragged_line(label, r))
            continue
        log(f"  {label} ({r['kernel']}): {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; "
            f"without the hold {r['ms_host_gap']:.4f} ms)")
    log("ENCDEC_VLM_KERNELS " + json.dumps(rows))
    return rows


def whisper_family(torch, prompts):
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, d 768, 12 heads of 64, 1,500 frames, padded vocab 52,224) on
    random bf16 weights: each request (its own seeded stub frames, ×0.02)
    through ``Model.prefill(frames=..., paged=False)`` at batch 1, the four
    caches stacked on the batch axis, then 31 greedy ``Model.decode_step``s
    at batch 4 (32 tokens a request), launches counted from 0 over that
    run. Held: flash and contiguous decode launched (on the tensor cores),
    the paged kernels and wkv6 not; each request's prefill and decode
    logits at tokens 0, 1, 16 and 31 against one full decoder forward over
    the same context, to ``ENCDEC_REL`` of its largest |logit|. Reported:
    the encoder's and one 412-token prefill's device ms, the decode-step
    p50 (host clock around a synchronised step) and its device ms (4
    profiled steps)."""
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    cfg, model, params, info = family_params(torch, "whisper-small")
    g = torch.Generator(device="cuda").manual_seed(7)
    frames = [(torch.randn((1, cfg.n_audio_frames, cfg.d_model),
                           generator=g, device="cuda") * 0.02).bfloat16()
              for _ in prompts]
    toks = [torch.tensor([p], dtype=torch.int32, device="cuda")
            for p in prompts]
    lens = [len(p) for p in prompts]
    label = "whisper prefill at batch 1 -> decode at batch 4, contiguous"

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches, logits = [], []
    for t, f in zip(toks, frames):
        lg, c = model.prefill(params, t, WHISPER_MAX_SEQ, frames=f,
                              paged=False)
        caches.append(c)
        logits.append(lg)
    cache = {part: {leaf: torch.cat([c[part][leaf] for c in caches], dim=1)
                    for leaf in ("k", "v")} for part in ("self", "cross")}
    del caches
    logits = [torch.cat(logits)]
    streams = [[t] for t in logits[0].argmax(-1).tolist()]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_ms = []
    for n in range(MAX_NEW - 1):
        tok = torch.tensor([[s[-1]] for s in streams], dtype=torch.int32,
                           device="cuda")
        pos = torch.tensor([[n_ + n] for n_ in lens], dtype=torch.int32,
                           device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, tok, pos)
        nxt = lg.argmax(-1).tolist()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
        for s, x in zip(streams, nxt):
            s.append(x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for k in ("flash_attention", "decode_attention"):
        if counts[k] <= 0:
            raise AssertionError(f"{label}: {k} never launched ({counts})")
    for k in ("ragged_paged_attention", "ragged_paged_attention_q8",
              "paged_decode_attention", "wkv6"):
        if counts[k] != 0:
            raise AssertionError(f"{label}: {k} launched ({counts})")
    bodies = check_bodies(counts, label)
    if not all(len(s) == MAX_NEW and all(0 <= t < cfg.vocab for t in s)
               for s in streams):
        raise AssertionError(f"{label}: bad streams {streams}")

    # the card's test_decode_matches_full_forward
    worst = []
    for i, prompt in enumerate(prompts):
        ckv = {leaf: cache["cross"][leaf][:, i:i + 1] for leaf in ("k", "v")}
        for n in (0, 1, 16, MAX_NEW - 1):
            ids = torch.tensor([prompt + streams[i][:n]], dtype=torch.int32,
                               device="cuda")
            pos = torch.arange(ids.shape[1], dtype=torch.int32,
                               device="cuda")[None]
            h, _ = encdec.decoder(cfg, params, ids, pos, cross_kv=ckv,
                                  dtype=model.dtype)
            full = encdec.head(cfg, params, h[:, -1])[0, :cfg.vocab].float()
            got = logits[n][i, :cfg.vocab].float()
            ratio = float((got - full).abs().max() / full.abs().max())
            worst.append({"request": i, "token": n, "rel_err": ratio,
                          "argmax_equal": int(got.argmax())
                          == int(full.argmax())})
    rel = max(w["rel_err"] for w in worst)
    if not rel <= ENCDEC_REL:
        raise AssertionError(f"whisper: decode logits leave the full "
                             f"forward's by {rel:.4g} of their largest "
                             f"|logit| (> {ENCDEC_REL})")
    log(f"  whisper: prefill + decode logits within {rel:.4g} of the full "
        f"forward's largest |logit| (limit {ENCDEC_REL:.4g}); argmax equal "
        f"at {sum(w['argmax_equal'] for w in worst)} of {len(worst)}")

    enc_ms, _, enc_wall, enc_top = profiled_call(
        torch, lambda: encdec.encode(cfg, params, frames[2]),
        ("flash_wgmma_kernel", "flash_kernel"))
    pre_ms, pre_attn, pre_wall, pre_top = profiled_prefill(
        torch, model, params, toks[2], dict(frames=frames[2], paged=False),
        ("flash_wgmma_kernel", "flash_kernel"))
    n_prof = 4
    base = MAX_NEW - 1
    tok = torch.tensor([[s[-1]] for s in streams], dtype=torch.int32,
                       device="cuda")
    it = iter(range(n_prof))

    def step():
        k = next(it)
        pos = torch.tensor([[n_ + base + k] for n_ in lens],
                           dtype=torch.int32, device="cuda")
        model.decode_step(params, cache, tok, pos)

    prof = profile_steps(torch, step, n=n_prof)
    p50 = sorted(step_ms)[len(step_ms) // 2]
    rec = {"model": info, "launches": counts, "bodies": bodies,
           "streams_head": [s[:8] for s in streams],
           "full_forward_check": worst, "full_forward_rel_max": rel,
           "prefill_s_4_requests": prefill_s,
           "prefill_tok_s": sum(lens) / prefill_s,
           "decode_step_ms_p50": p50,
           "decode_step_ms_p99": sorted(step_ms)[
               min(len(step_ms) - 1, int(round(0.99 * (len(step_ms) - 1))))],
           "decode_tok_s": 4 * len(step_ms) / (sum(step_ms) / 1e3),
           "device_ms_per_decode_step": prof["device_ms_per_step"],
           "busy": prof["device_ms_per_step"] / p50,
           "decode_top_kernels_ms": prof["top_kernels_ms_per_step"],
           "encoder_device_ms": enc_ms, "encoder_profiled_wall_ms": enc_wall,
           "encoder_top_kernels_ms": enc_top,
           "prefill_412_device_ms": pre_ms,
           "prefill_412_flash_ms": pre_attn,
           "prefill_412_profiled_wall_ms": pre_wall,
           "prefill_412_top_kernels_ms": pre_top}
    log(f"  {label}: 4 prefills in {prefill_s * 1e3:.1f} ms "
        f"({rec['prefill_tok_s']:.1f} tok/s), decode step p50 {p50:.2f} ms "
        f"p99 {rec['decode_step_ms_p99']:.2f} ms, device "
        f"{rec['device_ms_per_decode_step']:.2f} ms a decode step (busy "
        f"{rec['busy']:.3f}); encoder {enc_ms:.3f} device ms, 412-token "
        f"prefill {pre_ms:.3f} device ms (flash {pre_attn:.3f}); launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    return rec


def vlm_family(torch):
    """llava-next-34b at full width and depth (60 layers, d 7168, 56 q / 8
    kv heads of 128, d_ff 20480, vocab 64000; 64.05 GiB of bf16 weights,
    the stages views of them) through ``ServingEndpoint`` at batch 4,
    ``max_seq`` 1,024: the main prompts, the first three each behind a
    576-row image prefix (seeded, ×0.02), the fourth text-only. Paged
    (chunks of 256) and contiguous, each as a 2-stage endpoint
    consolidated after 4 tokens (the prefix rows' K/V migrate with the
    rest) against a 1-stage one: streams equal exactly on each layout.
    Then fused engines over bf16 and int8 pages with the text-only request
    (a prefix request refused at ``submit`` first, nothing admitted).
    Reported: the layouts' token agreement, each path's rates, decode-step
    p50 and device ms; one 988-row prefix prefill profiled on each
    layout."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine
    cfg, model, params, info = family_params(torch, "llava-next-34b")
    prompts = main_prompts(cfg.vocab)
    g = torch.Generator(device="cuda").manual_seed(8)
    prefixes = [(torch.randn((VLM_IMAGE_ROWS, cfg.d_model), generator=g,
                             device="cuda") * 0.02).bfloat16()
                if i != VLM_TEXT_ONLY else None for i in range(len(prompts))]
    paths, launches, bodies, streams = {}, {}, {}, {}

    def run(label, ep, expect, absent, consolidate=None, sel=None):
        sel = sel or list(range(len(prompts)))
        s, c, b, st = family_path(
            torch, label, ep, [prompts[i] for i in sel], expect, absent,
            consolidate, prefixes=[prefixes[i] for i in sel])
        paths[label], launches[label], bodies[label] = st, c, b
        streams[label] = s
        return s

    layouts = {
        "paged": (dict(FAM_KW, paged=True, prefill_chunk=256),
                  ("flash_attention", "ragged_paged_attention",
                   "paged_decode_attention"), ("decode_attention",)),
        "contiguous": (dict(FAM_KW, paged=False),
                       ("flash_attention", "decode_attention"),
                       ("ragged_paged_attention", "paged_decode_attention")),
    }
    one = {}
    for name, (kw, expect, absent) in layouts.items():
        stages = [model.slice_stage_params(params, 2, i) for i in range(2)]
        ep = ServingEndpoint(Engine(cfg, stages, **kw))
        main = run(f"llava 2-stage -> consolidated, {name}", ep, expect,
                   absent, consolidate=lambda: ep.consolidate(params))
        del ep, stages
        one[name] = run(f"llava 1-stage, {name}",
                        ServingEndpoint(Engine(cfg, [params], **kw)), expect,
                        absent)
        if main != one[name]:
            raise AssertionError(f"llava: 2-stage + consolidation streams "
                                 f"differ from the 1-stage engine's on the "
                                 f"{name} layout:\n{main}\n{one[name]}")
        log(f"  streams: llava 2-stage + consolidation == 1-stage ({name})")
    agree = agreement(one["contiguous"], one["paged"])
    log(f"  llava contiguous vs paged streams: agree on {agree[0]:.3f} of "
        f"tokens, first parting token of each request {agree[1]}")

    fused = {}
    for kv_dtype, kernel in ((None, "ragged_paged_attention"),
                             ("int8", "ragged_paged_attention_q8")):
        eng = Engine(cfg, [params], fused=True, kv_dtype=kv_dtype,
                     **dict(FAM_KW, paged=True, prefill_chunk=256))
        before = eng.stats()
        try:
            eng.submit(prompts[0], SamplingParams(max_new=MAX_NEW),
                       prefix_embeds=prefixes[0])
        except ValueError as e:
            if "prefix_embeds" not in str(e):
                raise
        else:
            raise AssertionError("llava fused: a prefix request was taken")
        if eng.stats() != before or eng.queue or eng.has_work():
            raise AssertionError("llava fused: the refused prefix request "
                                 "left state behind")
        label = f"llava 1-stage fused, {kv_dtype or 'bf16'} pages, text-only"
        s = run(label, ServingEndpoint(eng), (kernel,),
                ("paged_decode_attention", "flash_attention",
                 "decode_attention"), sel=[VLM_TEXT_ONLY])
        fused[label] = agreement(s, [one["paged"][VLM_TEXT_ONLY]])
    log(f"  llava fused text-only stream vs the 1-stage paged one "
        f"(share, first parting token): {fused}; a prefix request refused "
        f"before admission on both")
    del eng
    tokens = torch.tensor([prompts[2]], dtype=torch.int32, device="cuda")
    pre = prefixes[2][None]
    prefill = {}
    for name, kw in (("contiguous", dict(paged=False)),
                     ("paged", dict(paged=True))):
        ms, attn, wall, top = profiled_prefill(
            torch, model, params, tokens, dict(kw, prefix_embeds=pre),
            ("flash_wgmma_kernel", "flash_kernel"))
        prefill[name] = {"rows": VLM_IMAGE_ROWS + len(prompts[2]),
                         "device_ms": ms, "flash_ms": attn,
                         "flash_share": attn / ms, "profiled_wall_ms": wall,
                         "top_kernels_ms": top}
        log(f"  llava prefix prefill of {VLM_IMAGE_ROWS} + {len(prompts[2])}"
            f" rows, {name}: device {ms:.3f} ms, flash {attn:.3f} ms "
            f"({attn / ms:.3f}); profiled wall {wall:.1f} ms")
    return {"model": info, "paths": paths, "launches": launches,
            "bodies": bodies, "contiguous_vs_paged": agree,
            "fused_text_only_vs_paged": fused, "prefix_prefill": prefill}


def example_twins(torch):
    """Each of ``repro_torch.examples``' twins once on the card (their
    smoke sizes, float32): its ``main()`` must print its OK line (the store
    smoke's store goes to ``_smoke_store/`` in the checkout, deleted
    after)."""
    import contextlib
    import importlib
    import io
    import shutil
    out = {}
    store = ROOT / "_smoke_store"
    try:
        for name in ("quickstart", "store_coldstart_smoke",
                     "consolidation_demo", "streaming_demo"):
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            kw = ({"store_dir": str(store / "twin")}
                  if name == "store_coldstart_smoke" else {})
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(device="cuda", **kw)
            ok = [ln for ln in buf.getvalue().splitlines()
                  if ln.startswith("OK:")]
            if not ok:
                raise AssertionError(f"example twin {name}: no OK line")
            out[name] = {"ok": ok[-1], "s": time.perf_counter() - t0}
            log(f"  twin {name} on the card: {ok[-1]} "
                f"({out[name]['s']:.1f} s)")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return out


def encdec_vlm_phase(torch):
    """The ``ENCDEC_VLM`` phase: the attention kernels at whisper's and
    llava's shapes, then whisper-small, then llava-next-34b (whisper freed
    first), then the example twins. Returns every kernel's launches over
    the phase's paths, and the kernel rows."""
    import gc
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernels = encdec_vlm_kernel_phase(torch, 20, flush)
    del flush
    t0 = time.perf_counter()
    whisper = whisper_family(torch, main_prompts(
        get_config("whisper-small").vocab))
    whisper["phase_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    llava = vlm_family(torch)
    llava["phase_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    twins = example_twins(torch)
    total = dict(whisper["launches"])
    for counts in llava["launches"].values():
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    rec = {"kernels": kernels, "whisper-small": whisper,
           "llava-next-34b": llava, "example_twins": twins,
           "launches": total, "phase_s": time.perf_counter() - t_phase}
    log(f"  ENCDEC_VLM phase: {rec['phase_s']:.1f} s (whisper "
        f"{whisper['phase_s']:.1f} s, llava {llava['phase_s']:.1f} s)")
    log("ENCDEC_VLM " + json.dumps(rec))
    return total, kernels


# ---------------------------------------------------------------------------
# phase 11: training (TRAIN)
# ---------------------------------------------------------------------------


TRAIN_LAYERS = 8          # of granite-3-8b's 40: all 40 need ~100 GB at 12 B
                          # a param (bf16 params and grads, f32 moments)
TRAIN_STEPS = 6
TRAIN_LR = 3e-5           # AdamW's peak lr (warmup 2 steps, 8 in all)
TRAIN_LR_WITNESS = 1e-3   # the reference example's peak lr: at full width
                          # with 2 warmup steps its loss climbs (reported)
TRAIN_LOSS_REL = 1e-2     # one step's loss, kernel vs plain forward
TRAIN_GNORM_REL = 3e-2    # its global gradient norm, kernel vs plain
TRAIN_COSINE = 0.99       # each gradient leaf's cosine, kernel vs plain
TRAIN_DROP = 0.8          # step 6's loss below this times step 1's
TRAIN_TITLE = ("== training: granite-3-8b's train step at full width, "
               f"{TRAIN_LAYERS} of 40 layers (flash forward, plain "
               "backward, AdamW)")


def train_kernel(torch, seq, reps, flush):
    """The flash kernel at the train step's shape (B 1, ``seq`` rows,
    causal, 32 q / 8 kv heads of 128, bf16): launched once on its
    tensor-core body and held row by row against its float32 plain
    version, then timed beside its bound, its plain version and one SDPA
    call; and, for the backward the step takes from the plain version
    (``ops.flash_backward_plain``), its time beside one SDPA forward and
    backward (never called by the port). Printed as ``TRAIN_KERNEL``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(41)
    b, s, hq, hkv, hd = 1, seq, Hq, HKV, HD
    q, k, v = (torch.randn((b, s, h, hd), generator=g,
                           device="cuda").bfloat16()
               for h in (hq, hkv, hkv))
    dout = torch.randn((b, s, hq, hd), generator=g,
                       device="cuda").bfloat16()
    ops.reset_launch_counts()
    got = kfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if (ops.body_counts()["flash_attention/tensor_core"],
            ops.body_counts()["flash_attention/cuda_core"]) != (1, 0):
        raise AssertionError(f"TRAIN_KERNEL: flash not on the tensor cores "
                             f"({ops.body_counts()})")
    err = check_rows(f"flash at the train shape (1 x {seq}, causal)", got,
                     ref.mha_reference(q.float(), k.float(), v.float()))
    b_ms, b_by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                          4 * hq * hd * flash_pairs(b, s, s, True),
                          BF16_FLOPS)
    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k.repeat_interleave(hq // hkv, dim=2),
                            v.repeat_interleave(hq // hkv, dim=2)))
    dd = dout.transpose(1, 2).contiguous()

    def library_fwd_bwd():
        out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        torch.autograd.grad(out, (qq, kk, vv), dd)

    rec = dict(kernel="flash_attention",
               **kernel_ms(torch, lambda: kfa.flash_attention(q, k, v),
                           reps, flush),
               plain_ms=time_ms(torch, lambda: ref.mha_reference(q, k, v), 3,
                                1, flush),
               library_ms=time_ms(torch, sdpa_flash(torch, q, k, v), reps,
                                  flush=flush),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err[0],
               err_over_tol=err[1],
               backward_plain_ms=time_ms(
                   torch, lambda: ops.flash_backward_plain(
                       q, k, v, dout, True, 0), 3, 1, flush),
               library_fwd_bwd_ms=time_ms(torch, library_fwd_bwd, 5, 1,
                                          flush))
    rec.update(flash_stats(torch, lambda: kfa.flash_attention(q, k, v),
                           4 * hq * hd * flash_pairs(b, s, s, True),
                           rec["ms"]))
    log(f"  flash at the train shape: {rec['ms']:.4f} ms, tile "
        f"{rec['tile_rows']} rows, {rec['tflops']:.1f} TFLOP/s")
    log("TRAIN_KERNEL " + json.dumps(rec))
    return rec


def _span_timer(torch, spans, name, fn):
    """``fn`` with CUDA events recorded around each call, into
    ``spans[name]`` (device time of the call's work on the stream)."""
    def run(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        spans.setdefault(name, []).append((start, end))
        return out
    return run


def train_compare(torch, model, params, batch):
    """One step's loss and gradients from the same params and batch
    through the flash kernel (``_FlashFn``) and through a forward on the
    plain version (swapped into ``ops`` for that one call), both on the
    card with ``remat="full"``: the losses, the global gradient norms and
    each leaf's cosine."""
    from unittest import mock
    from repro_torch.kernels import ops, ref
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.train_step import loss_and_grads

    def plain(q, k, v, *, causal=True, q_offset=0, kv_len=None):
        return ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len)

    loss_k, _, g_k = loss_and_grads(model, params, batch, remat="full")
    with mock.patch.object(ops, "flash_attention", plain):
        loss_p, _, g_p = loss_and_grads(model, params, batch, remat="full")
    cos, sq_k, sq_p = [], 0.0, 0.0
    for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)):
        a, b = a.float().flatten(), b.float().flatten()
        cos.append(float(torch.nn.functional.cosine_similarity(a, b, dim=0,
                                                               eps=1e-30)))
        sq_k += float(a.square().sum())
        sq_p += float(b.square().sum())
    rec = {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "grad_norm_kernel": math.sqrt(sq_k),
           "grad_norm_plain": math.sqrt(sq_p), "min_leaf_cosine": min(cos)}
    rec["loss_rel"] = abs(rec["loss_kernel"] - rec["loss_plain"]) / abs(
        rec["loss_plain"])
    rec["grad_norm_rel"] = abs(rec["grad_norm_kernel"]
                               - rec["grad_norm_plain"]) / rec[
        "grad_norm_plain"]
    log(f"  kernel vs plain forward, one step: loss {rec['loss_kernel']:.6f}"
        f" / {rec['loss_plain']:.6f} (rel {rec['loss_rel']:.2e}, limit "
        f"{TRAIN_LOSS_REL}), grad norm {rec['grad_norm_kernel']:.6f} / "
        f"{rec['grad_norm_plain']:.6f} (rel {rec['grad_norm_rel']:.2e}, "
        f"limit {TRAIN_GNORM_REL}), least leaf cosine "
        f"{rec['min_leaf_cosine']:.6f} (limit {TRAIN_COSINE})")
    if not (rec["loss_rel"] <= TRAIN_LOSS_REL
            and rec["grad_norm_rel"] <= TRAIN_GNORM_REL
            and rec["min_leaf_cosine"] >= TRAIN_COSINE):
        raise AssertionError(f"TRAIN: kernel and plain forwards disagree: "
                             f"{rec}")
    return rec


def train_profile(torch, step, params, state, batch):
    """One more train step under ``torch.profiler``, with CUDA events around
    each plain flash backward and around ``apply_updates`` (wrappers
    installed for this step only). Returns (params, state, the record:
    the step's device ms, busy share of its wall time, and the device ms
    and share of the flash forward kernel, the plain backwards and the
    update)."""
    from unittest import mock
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.training import optimizer as opt
    spans = {}
    with mock.patch.object(ops, "flash_backward_plain", _span_timer(
            torch, spans, "backward_plain", ops.flash_backward_plain)), \
            mock.patch.object(opt, "apply_updates", _span_timer(
                torch, spans, "apply_updates", opt.apply_updates)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kern = {e.key: _dev_ms(e) / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    device = sum(kern.values())
    flash = sum(v for k, v in kern.items()
                if "flash_wgmma_kernel" in k or "flash_kernel" in k)
    rec = {"device_ms": device, "profiled_wall_ms": wall,
           "busy": device / wall, "flash_forward_ms": flash,
           "flash_forward_share": flash / device,
           "top_kernels_ms": {k[:60]: v for k, v in sorted(
               kern.items(), key=lambda kv: -kv[1])[:6]}}
    for name, pairs in spans.items():
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        rec[f"{name}_ms"], rec[f"{name}_share"] = ms, ms / device
        rec[f"{name}_calls"] = len(pairs)
    return params, state, rec


def train_lr_witness(torch, model, batch):
    """``TRAIN_STEPS`` steps from the same params (drawn again from the
    same seed) at a peak lr of ``TRAIN_LR_WITNESS``, the rest as the main
    path: the losses, reported, not held."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    step = make_train_step(model, opt.AdamWConfig(
        lr=TRAIN_LR_WITNESS, warmup_steps=2, total_steps=8), remat="full",
        grad_dtype="bfloat16")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    state, losses = opt.init_state(params), []
    for _ in range(TRAIN_STEPS):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    log(f"  peak lr {TRAIN_LR_WITNESS} (reported): losses {losses}; step "
        f"{TRAIN_STEPS} over step 1 {losses[-1] / losses[0]:.3f}")
    return {"lr": TRAIN_LR_WITNESS, "losses": losses}


def train_small_twin(torch):
    """The ``train_small`` twin on the card: 3 steps into a checkpoint
    directory in the checkout (deleted after), then a second call resumes
    from step 3 and runs to 5."""
    import contextlib
    import io
    import shutil
    from repro_torch.examples import train_small
    ck = ROOT / "_train_small_smoke"
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            first = train_small.main(steps=3, fresh=True, device="cuda",
                                     ckpt_dir=str(ck))
            second = train_small.main(steps=5, device="cuda",
                                      ckpt_dir=str(ck))
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    losses = [float(first[i]["loss"]) for i in sorted(first)] + \
        [float(second[i]["loss"]) for i in sorted(second)]
    if "restored checkpoint at step 3" not in buf.getvalue() or \
            sorted(second) != [3, 4] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_small twin on the card: {losses}\n"
                             f"{buf.getvalue()}")
    log(f"  twin train_small on the card: losses {losses}, resumed at step 3"
        f" ({secs:.1f} s)")
    return {"losses": losses, "s": secs}


def train_phase(torch, smi):
    """The ``TRAIN`` phase: granite-3-8b at full width (d 4096, 32 q / 8 kv
    heads of 128, d_ff 12800, vocab 49155, bf16), ``TRAIN_LAYERS`` of its
    40 layers, random weights from a seeded generator, on the production
    per-chip train shape (``SHAPES["train_4k"]``: 256 sequences of 4,096
    over 256 chips, so one sequence here; ``SyntheticTokens`` seed 0).
    First one step's gradients through the kernel against a plain forward
    (``train_compare``); then ``TRAIN_STEPS`` steps of
    ``make_train_step(remat="full", grad_dtype="bfloat16")`` at a peak lr
    of ``TRAIN_LR`` on the one batch, counted from 0 (flash 16 launches a
    step, all on the tensor cores, and 8 plain backwards); then one
    profiled step (``train_profile``), the same steps at a peak lr of
    ``TRAIN_LR_WITNESS`` from the same params (``train_lr_witness``) and
    the ``train_small`` twin; first of all, the flash kernel alone at the
    step's shape (``train_kernel``). Returns the main path's launches and
    the kernel's row."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.roofline import analytic
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticTokens
    from repro_torch.training.train_step import make_train_step
    import gc
    t_phase = time.perf_counter()
    full = get_config("granite-3-8b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    prod = SHAPES["train_4k"]
    shape = dataclasses.replace(prod, global_batch=prod.global_batch // 256)
    model = Model(cfg)
    n_params = sum(math.prod(d.shape) for d in tree_leaves(model.defs))
    n_full = sum(math.prod(d.shape) for d in tree_leaves(Model(full).defs))
    resident = 12 * n_params
    log(f"  depth cut to {TRAIN_LAYERS} of {full.n_layers} layers: all "
        f"{full.n_layers} hold {n_full / 1e9:.3f} B params, "
        f"{12 * n_full / 1e9:.1f} GB at 12 B a param (bf16 params and "
        f"grads, two f32 moments), over the card's 80 GB before any "
        f"activation; {TRAIN_LAYERS} hold {n_params / 1e9:.3f} B, "
        f"{resident / 1e9:.2f} GB resident")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernel = train_kernel(torch, shape.seq_len, 20, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter(
        SyntheticTokens(cfg, shape.global_batch, shape.seq_len,
                        seed=0))).items()}
    compare = train_compare(torch, model, params, batch)
    gc.collect()
    torch.cuda.empty_cache()

    acfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=8)
    step = make_train_step(model, acfg, remat="full",
                           grad_dtype="bfloat16")
    state = opt.init_state(params)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches, bodies = ops.launch_counts(), ops.body_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {losses}; step ms {[round(t, 2) for t in step_ms]}")
    want_flash = 2 * TRAIN_LAYERS * TRAIN_STEPS
    if not all(map(math.isfinite, losses)) or \
            not losses[-1] < TRAIN_DROP * losses[0]:
        raise AssertionError(f"TRAIN: losses {losses}: want finite, step "
                             f"{TRAIN_STEPS} below {TRAIN_DROP} x step 1")
    if (launches["flash_attention"] != want_flash
            or bodies["flash_attention/tensor_core"] != want_flash
            or bodies["flash_attention/backward_plain"]
            != TRAIN_LAYERS * TRAIN_STEPS
            or any(n for k, n in launches.items()
                   if k != "flash_attention")):
        raise AssertionError(f"TRAIN: launches {launches}, bodies {bodies}:"
                             f" want flash {want_flash} on the tensor "
                             f"cores, {TRAIN_LAYERS * TRAIN_STEPS} plain "
                             f"backwards, nothing else")
    params, state, prof = train_profile(torch, step, params, state, batch)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    witness = train_lr_witness(torch, model, batch)
    gc.collect()
    torch.cuda.empty_cache()
    twin = train_small_twin(torch)

    p50 = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    fwd = analytic.step_flops(cfg, shape)
    rec = {"device": smi, "model": "granite-3-8b", "layers": TRAIN_LAYERS,
           "lr": TRAIN_LR,
           "of_layers": full.n_layers, "batch": shape.global_batch,
           "seq": shape.seq_len, "params": n_params, "remat": "full",
           "grad_dtype": "bfloat16", "losses": losses, "step_ms": step_ms,
           "step_ms_p50": p50,
           "tokens_per_s": shape.global_batch * shape.seq_len / p50 * 1e3,
           "forward_flops": fwd, "train_flops": 3 * fwd,
           "train_mfu": 3 * fwd / (p50 / 1e3) / BF16_FLOPS,
           "max_memory_allocated": peak, "resident_bytes": resident,
           "compare": compare, "launches": launches, "bodies": bodies,
           "kernel": kernel, "profile": prof, "lr_witness": witness,
           "train_small_twin": twin,
           "phase_s": time.perf_counter() - t_phase}
    log(f"  {smi}: peak lr {TRAIN_LR}, step p50 {p50:.2f} ms (steps "
        f"2-{TRAIN_STEPS}), "
        f"{rec['tokens_per_s']:.1f} tokens/s, train_mfu "
        f"{rec['train_mfu']:.4f} (3 x {fwd:.4e} forward FLOPs over the step "
        f"over {BF16_FLOPS:.3e} FLOP/s), busy {prof['busy']:.3f} of one "
        f"profiled step; flash forward {prof['flash_forward_share']:.3f}, "
        f"plain backward {prof['backward_plain_share']:.3f}, apply_updates "
        f"{prof['apply_updates_share']:.3f} of its device time; "
        f"max allocated {peak / 2**30:.2f} GiB vs {resident / 2**30:.2f} "
        f"GiB resident from the defs")
    log(f"  TRAIN phase: {rec['phase_s']:.1f} s")
    log("TRAIN " + json.dumps(rec))
    return launches, kernel


DIST_SEQ = 32_768         # SHAPES["prefill_32k"]'s sequence
DIST_BATCH = 2            # its global batch 32 over a data axis of 16
DIST_MICRO = 2            # the pipelined prefill's micro-batches
DIST_REL = 2.0 ** -5      # last-token logits vs the reference forward's
                          # largest |logit| (the ENCDEC_VLM phase's limit)
DIST_KV_REL = 2.0 ** -7   # each manual-TP K/V layer vs the forward's, of
DIST_KV_ATOL = 1e-4       # that layer's largest |value|, plus this
DIST2_BATCH = 1           # the two-rank manual-TP run's tokens: gloo moves
DIST2_SEQ = 8_192         # every collective through the host
DIST_TITLE = ("== distributed prefills: granite-3-8b's manual-TP and "
              f"pipelined prefills at full width and depth, B {DIST_BATCH}"
              f" x {DIST_SEQ} (one NCCL rank), and manual TP at tp 2 on B "
              f"{DIST2_BATCH} x {DIST2_SEQ} (two gloo ranks)")


def dist_kernel(torch, label, b, s, hq, hkv, pairs, reps, flush):
    """The flash kernel at one of the ``DIST`` path's shapes (B ``b``, ``s``
    rows, causal, ``hq`` q heads over ``hkv`` kv heads of 128, bf16):
    launched once on its tensor-core body and held row by row against its
    float32 plain version at each (batch row, q head) of ``pairs`` with that
    head's kv head (the whole plain version would hold a float32 score
    tensor of 4.3 GB a head and row at 32,768), in query chunks of 4,096
    (``q_offset``); then timed beside its bound, its plain version on batch
    row 0, q head 0, and one SDPA call (never called by the port)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(53)
    hd, group = HD, hq // hkv
    q = torch.randn((b, s, hq, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((b, s, hkv, hd), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    ops.reset_launch_counts()
    got = kfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if (ops.body_counts()["flash_attention/tensor_core"],
            ops.body_counts()["flash_attention/cuda_core"]) != (1, 0):
        raise AssertionError(f"{label}: flash not on the tensor cores "
                             f"({ops.body_counts()})")
    err, ratio, chunk = 0.0, 0.0, 4096
    for row, head in pairs:
        rs, qs = slice(row, row + 1), slice(head, head + 1)
        ks = slice(head // group, head // group + 1)
        for c0 in range(0, s, chunk):
            want = ref.mha_reference(
                q[rs, c0:c0 + chunk, qs].float(),
                k[rs, :c0 + chunk, ks].float(),
                v[rs, :c0 + chunk, ks].float(), causal=True, q_offset=c0)
            d = (got[rs, c0:c0 + chunk, qs].float() - want).abs().amax(-1)
            lim = ROW_REL * want.abs().amax(-1) + ROW_ATOL
            err = max(err, float(d.max()))
            ratio = max(ratio, float((d / lim).max()))
    if not math.isfinite(ratio) or ratio > 1:
        raise AssertionError(f"{label}: a row's error is {ratio:.3f} of its "
                             f"limit (max abs err {err:.3e})")
    log(f"  flash at {label}: (row, q head) {list(pairs)} max abs err "
        f"{err:.3e}, worst row at {ratio:.3f} of its limit "
        f"({ROW_REL:.4g}*max|row| + {ROW_ATOL})")
    del got
    b_ms, b_by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                          4 * hq * hd * flash_pairs(b, s, s, True),
                          BF16_FLOPS)
    one = (slice(0, 1), slice(None), slice(0, 1))
    rec = dict(kernel="flash_attention", shape=label, batch=b, seq=s,
               q_heads=hq, kv_heads=hkv, head_dim=hd,
               checked_pairs=[list(p) for p in pairs],
               **kernel_ms(torch, lambda: kfa.flash_attention(q, k, v),
                           reps, flush),
               plain_ms=time_ms(torch, lambda: ref.mha_reference(
                   q[one], k[one], v[one]), 2, 1, flush),
               plain_on="batch row 0, q head 0 (1 of "
                        f"{b * hq} row-heads)",
               library_ms=time_ms(torch, sdpa_flash(torch, q, k, v), reps,
                                  flush=flush),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               err_over_tol=ratio)
    rec.update(flash_stats(torch, lambda: kfa.flash_attention(q, k, v),
                           4 * hq * hd * flash_pairs(b, s, s, True),
                           rec["ms"]))
    return rec


def dist_kernels(torch, cfg, flush):
    """``dist_kernel`` at every shape the ``DIST`` path launches flash at:
    the reference forward's (B 2 x ``DIST_SEQ``, 32 q over 8 kv heads: G
    4), the manual-TP prefill's at tp 1 (32 q heads over the 32 kv heads
    they select: G 1), a tp = 16 rank's (2 q heads at G 1), the pipeline's
    micro-batch (B 1, G 4) and a rank's of the two-rank manual-TP run (B
    ``DIST2_BATCH`` x ``DIST2_SEQ``, 16 q heads at G 1; that run's own
    forward is the pipeline's shape over its first ``DIST2_SEQ`` rows).
    Keyed by run."""
    hq, hkv, b, s = cfg.n_heads, cfg.n_kv_heads, DIST_BATCH, DIST_SEQ
    ends = ((0, 0), (b - 1, hq - 1))
    # three q heads of three kv heads, at group positions 0, 1 and 3
    spread = ((0, 0), (0, hq // 2 + 1), (0, hq - 1))
    shapes = {
        "forward": (f"the forward (B {b}, {s}, {hq} q over {hkv} kv heads: "
                    f"G {hq // hkv})", b, s, hq, hkv,
                    ((0, 0), (0, hq // 2 + 1), (b - 1, hq - 1))),
        "tp1": (f"tp 1 (B {b}, {s}, {hq} q heads at G 1)", b, s, hq, hq,
                ends),
        "tp16": (f"a tp = 16 rank (B {b}, {s}, {hq // 16} q heads at G 1)",
                 b, s, hq // 16, hq // 16, ((0, 0), (b - 1, hq // 16 - 1))),
        "pipeline": (f"a pipeline micro-batch (B 1, {s}, {hq} q over {hkv} "
                     f"kv heads: G {hq // hkv})", 1, s, hq, hkv, spread),
        "tp2": (f"a tp = 2 rank (B {DIST2_BATCH}, {DIST2_SEQ}, {hq // 2} q "
                f"heads at G 1)", DIST2_BATCH, DIST2_SEQ, hq // 2, hq // 2,
                ((0, 0), (0, hq // 2 - 1))),
    }
    out = {}
    for key, (label, *shape) in shapes.items():
        out[key] = r = dist_kernel(torch, label, *shape, 5, flush)
        log(f"  DIST kernel {r['shape']}: {r['ms']:.3f} ms (bound "
            f"{r['bound_ms']:.3f}, {r['bound_by']}; SDPA "
            f"{r['library_ms']:.3f}; plain {r['plain_ms']:.3f} on "
            f"{r['plain_on']}; tile {r['tile_rows']} rows, "
            f"{r['tflops']:.1f} TFLOP/s)")
    log("DIST_KERNELS " + json.dumps(out))
    return out


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _granite_inputs(torch, cfg, batch, seq):
    """granite-3-8b's random weights (seed 0) and tokens (seed 1) on the
    card: the same in every process that asks."""
    from repro_torch.models.model import Model
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    tokens = torch.randint(0, cfg.vocab, (batch, seq),
                           generator=torch.Generator(
                               device="cuda").manual_seed(1),
                           dtype=torch.int32, device="cuda")
    return model, params, tokens


def manual_tp_plain(torch, cfg, params, tokens, tp):
    """The manual-TP prefill's arithmetic at ``tp`` ranks in one process,
    with no process group: every rank's sharded GEMMs on the same shard
    views (``manual_tp.shard_params``) over the whole sequence, its partial
    sums added in float32 and rounded to bf16 once, as the reduce-scatter
    does; attention through one flash launch a layer over all q heads at
    the model's group (a G 1 launch on selected kv heads gives its bits).
    Rank offsets, kv-head selection and the collectives are what it leaves
    out, so the two-rank program must give its bits. Returns (the last
    token's logits over the padded vocab, {"k", "v"}: (L, B, S, Hkv,
    hd))."""
    from repro_torch.distributed import manual_tp
    from repro_torch.kernels import ops
    from repro_torch.models.common import apply_rope, rmsnorm, silu
    b, s = tokens.shape
    hq, hkv, hd, eps = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.norm_eps
    shards = [manual_tp.shard_params(cfg, params, r, tp) for r in range(tp)]
    full = params["blocks"]["slot00"]["mixer"]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = params["embed"]["tok"][tokens.long()]
    ks, vs = [], []
    for i in range(cfg.n_periods):
        mix = [sh["blocks"]["slot00"]["mixer"] for sh in shards]
        mlp = [sh["blocks"]["slot00"]["mlp"] for sh in shards]
        xn = rmsnorm(x, full["norm"][i], eps)
        q = torch.cat([(xn @ m["w_q"][i]).reshape(b, s, hq // tp, hd)
                       for m in mix], 2)
        k = apply_rope((xn @ full["w_k"][i]).reshape(b, s, hkv, hd),
                       positions, cfg.rope_theta)
        v = (xn @ full["w_v"][i]).reshape(b, s, hkv, hd)
        out = ops.flash_attention(apply_rope(q, positions, cfg.rope_theta),
                                  k, v, causal=True).chunk(tp, 2)
        y = sum((o.reshape(b, s, -1) @ m["w_o"][i]).float()
                for o, m in zip(out, mix))
        x = x + y.to(x.dtype)
        xn = rmsnorm(x, mlp[0]["norm"][i], eps)
        y = sum(((silu(xn @ m["w_gate"][i]) * (xn @ m["w_up"][i]))
                 @ m["w_down"][i]).float() for m in mlp)
        x = x + y.to(x.dtype)
        ks.append(k)
        vs.append(v)
    last = rmsnorm(x, params["final_norm"], eps)[:, -1]
    logits = torch.cat([last @ sh["lm_head"] for sh in shards], -1)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def dist_rank(torch, rank, port):
    """One rank of the two-rank manual-TP prefill (``dist_two_ranks``): in
    its own process, on a gloo process group of 2 over CUDA tensors. On the
    full weights it runs the one-rank forward (``Model.prefill(paged=
    False)``) and ``manual_tp_plain`` at tp 2 first, then its manual-TP
    prefill at tp 2 on its shards with its launches counted from 0. Its
    vocab columns of the last-token logits are held against both within
    ``DIST_REL`` of the forward's largest |logit|; its sequence slice of
    every K/V layer against ``manual_tp_plain``'s within ``DIST_KV_REL`` of
    the layer's largest |value| plus ``DIST_KV_ATOL``, and against the
    forward's, reported (the partial sums round once more than the
    forward's single GEMM, and that drift grows with depth). Prints
    ``DIST_RANK`` and its record."""
    from datetime import timedelta
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.distributed import manual_tp
    cfg = get_config("granite-3-8b")
    b, s, tp = DIST2_BATCH, DIST2_SEQ, 2
    s_loc, v_loc = s // tp, cfg.padded_vocab // tp
    model, params, tokens = _granite_inputs(torch, cfg, b, s)
    with torch.no_grad():
        fwd_logits, fwd_cache = model.prefill(params, tokens, s,
                                              paged=False)[:2]
        plain_logits, plain_cache = manual_tp_plain(torch, cfg, params,
                                                    tokens, tp)
    fwd_cache = fwd_cache["slot00"]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=tp,
                            timeout=timedelta(seconds=120))
    try:
        # the mesh only names the group; gloo moves the CUDA tensors
        mesh = init_device_mesh("cpu", (1, tp),
                                mesh_dim_names=("data", "model"))
        fn = manual_tp.make_manual_prefill(cfg, mesh, b, s, tp=tp)[0]
        shards = manual_tp.shard_params(cfg, params, rank, tp)
        dist.barrier()
        (logits, cache), dev_ms, wall, peak, launches, bodies = _timed_run(
            torch, lambda: fn(shards, tokens))
    finally:
        dist.destroy_process_group()
    # this rank's vocab columns that are real tokens
    cols = torch.arange(rank * v_loc, (rank + 1) * v_loc, device="cuda")
    real = cols < cfg.vocab
    scale = float(fwd_logits[:, :cfg.vocab].float().abs().max())
    got = logits[:, real].float()
    lg = {"max_abs_logit": scale, "columns": [rank * v_loc,
                                              (rank + 1) * v_loc]}
    for name, want in (("forward", fwd_logits), ("plain", plain_logits)):
        err = float((got - want[:, cols[real]].float()).abs().max())
        lg[name] = {"max_abs_err": err, "err_over_max": err / scale}
    rows = slice(rank * s_loc, (rank + 1) * s_loc)
    kv = {}
    for ref_name, ref_cache in (("forward", fwd_cache),
                                ("plain", plain_cache)):
        ratios = []
        for name in ("k", "v"):
            for layer in range(cfg.n_layers):
                want = ref_cache[name][layer][:, rows].float()
                d = float((cache[name][layer].float() - want).abs().max())
                lim = DIST_KV_REL * float(
                    ref_cache[name][layer].float().abs().max()) + DIST_KV_ATOL
                ratios.append(d / lim if math.isfinite(d) else math.inf)
        n = cfg.n_layers
        kv[ref_name] = {"worst_over_limit": max(ratios),
                        "k_by_layer": ratios[:n], "v_by_layer": ratios[n:]}
    print("DIST_RANK " + json.dumps({
        "rank": rank, "device_ms": dev_ms, "wall_ms": wall,
        "max_memory_allocated": peak, "launches": launches, "bodies": bodies,
        "logits": lg, "kv": kv}), flush=True)


def dist_two_ranks(torch, cfg):
    """The manual-TP prefill at tp 2 as two processes on this card
    (``dist_rank``; NCCL refuses two ranks on one GPU, so they talk through
    gloo, which takes CUDA tensors for the all-gather, reduce-scatter and
    all-reduce manual TP uses): granite-3-8b at full width and depth on
    tokens of B ``DIST2_BATCH`` x ``DIST2_SEQ``. Each rank's flash launches
    are counted from 0 (40, on the tensor cores, nothing else); its logits
    within ``DIST_REL`` of the forward's largest |logit|, against the
    forward and against ``manual_tp_plain``; each K/V layer against
    ``manual_tp_plain``'s within ``DIST_KV_REL`` of its largest |value| plus
    ``DIST_KV_ATOL``. Both processes are killed after 300 s. Returns
    {rank: record}."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank",
         str(r), port], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    t0 = time.perf_counter()
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, 300 - (time.perf_counter() - t0))))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate())
    recs = {}
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in so.splitlines() if ln.startswith("DIST_RANK ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"DIST tp 2 rank {r}: exit {p.returncode}: "
                                 f"{se.strip()[-2000:]}")
        rec = json.loads(lines[-1][len("DIST_RANK "):])
        label = f"manual-TP prefill (tp 2, rank {r})"
        _check_dist_run(label, rec, rec["launches"], rec["bodies"],
                        cfg.n_layers)
        lg, kv = rec["logits"], rec["kv"]
        log(f"  {label} logits (columns {lg['columns']}), of max |logit| "
            f"{lg['max_abs_logit']:.3f}: vs the forward "
            f"{lg['forward']['err_over_max']:.3e}, vs manual_tp_plain "
            f"{lg['plain']['err_over_max']:.3e} (limit {DIST_REL:.4g}); "
            f"K/V worst layer vs manual_tp_plain at "
            f"{kv['plain']['worst_over_limit']:.3f} of its limit, vs the "
            f"forward at {kv['forward']['worst_over_limit']:.3f} (reported; "
            f"K layer 0 at {kv['forward']['k_by_layer'][0]:.3f}, layer "
            f"{cfg.n_layers - 1} at {kv['forward']['k_by_layer'][-1]:.3f})")
        for ref_name in ("forward", "plain"):
            e = lg[ref_name]["err_over_max"]
            if not math.isfinite(e) or e > DIST_REL:
                raise AssertionError(f"DIST {label}: logits vs {ref_name} "
                                     f"off by {e} of the largest |logit|")
        if not kv["plain"]["worst_over_limit"] <= 1:
            raise AssertionError(f"DIST {label}: a K/V layer at "
                                 f"{kv['plain']['worst_over_limit']} of its "
                                 f"limit against manual_tp_plain")
        recs[r] = rec
    return recs


def _timed_run(torch, fn):
    """``fn()`` with its launches counted from 0: (its output, device ms
    between CUDA events around it, wall ms to a synchronize, peak
    allocated bytes, launch counts, body counts)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    with torch.no_grad():
        out = fn()
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (out, a.elapsed_time(b), wall, torch.cuda.max_memory_allocated(),
            ops.launch_counts(), ops.body_counts())


def _check_dist_run(label, rec, launches, bodies, want_flash):
    if (launches["flash_attention"] != want_flash
            or bodies["flash_attention/tensor_core"] != want_flash
            or any(n for k, n in launches.items() if k != "flash_attention")):
        raise AssertionError(f"DIST {label}: launches {launches}, bodies "
                             f"{bodies}: want flash {want_flash} on the "
                             f"tensor cores and nothing else")
    log(f"  {label}: device {rec['device_ms']:.2f} ms, wall "
        f"{rec['wall_ms']:.2f} ms, peak allocated "
        f"{rec['max_memory_allocated'] / 2**30:.2f} GiB, flash launches "
        f"{want_flash} (tensor cores)")


def _logits_vs(torch, label, got, want, vocab):
    """Last-token logits over the real vocab against the reference
    forward's: the largest |diff| within DIST_REL of its largest |logit|;
    the argmax agreement reported."""
    g, w = got[:, :vocab].float(), want[:, :vocab].float()
    err = float((g - w).abs().max())
    scale = float(w.abs().max())
    agree = float((g.argmax(-1) == w.argmax(-1)).float().mean())
    log(f"  {label} logits vs the forward: max abs err {err:.4f} = "
        f"{err / scale:.3e} of max |logit| {scale:.3f} (limit "
        f"{DIST_REL:.4g}); argmax agrees on {agree:.3f} of rows (reported)")
    if not math.isfinite(err) or err > DIST_REL * scale:
        raise AssertionError(f"DIST {label}: logits off by {err} > "
                             f"{DIST_REL} x {scale}")
    return {"max_abs_err": err, "max_abs_logit": scale,
            "err_over_max": err / scale, "argmax_agree": agree}


def dist_phase(torch, smi):
    """The ``DIST`` phase: granite-3-8b at full width and depth (40 layers,
    d 4096, 32 q / 8 kv heads of 128, d_ff 12800, bf16, 15.60 GiB) on random
    weights from a seeded generator, tokens of B ``DIST_BATCH`` x
    ``DIST_SEQ`` (the ``prefill_32k`` cell's share of one data rank). First
    the flash kernel alone at every shape the phase launches it at
    (``dist_kernels``). Then the manual-TP prefill at tp 2 as two gloo
    processes on the card (``dist_two_ranks``, B ``DIST2_BATCH`` x
    ``DIST2_SEQ``). Then, on a one-rank NCCL process group: the reference
    forward (``Model.prefill(paged=False)``), the manual-TP prefill at tp 1
    (``distributed/manual_tp.py``) and the pipelined prefill at one stage
    with ``DIST_MICRO`` micro-batches (``distributed/pp_spmd.py``), each
    run's launches counted from 0 (flash 40, 40 and 80, all on the tensor
    cores, nothing else). Held: each run's logits within ``DIST_REL`` of the
    forward's largest |logit|, each manual-TP K/V layer within
    ``DIST_KV_REL`` of the forward's layer's largest |value| plus
    ``DIST_KV_ATOL``. The pipeline runs at one stage only: gloo refuses
    send/recv of CUDA tensors, so its two-stage semantics are held on the
    CPU (``tests/test_torch_distributed.py``). Returns (the launches of the
    manual-TP runs, both ranks of tp 2 included, and the pipeline's,
    summed; the kernel rows)."""
    import gc
    from datetime import timedelta
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.distributed import manual_tp, pp_spmd
    t_phase = time.perf_counter()
    cfg = get_config("granite-3-8b")
    assert cfg.n_layers == 40 and cfg.dtype == "bfloat16", cfg
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernels = dist_kernels(torch, cfg, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    two = dist_two_ranks(torch, cfg)

    model, params, tokens = _granite_inputs(torch, cfg, DIST_BATCH, DIST_SEQ)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            timeout=timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))
    runs, total = {}, {}
    try:
        def record(label, out, *rest):
            dev_ms, wall, peak, launches, bodies = rest
            runs[label] = {"device_ms": dev_ms, "wall_ms": wall,
                           "max_memory_allocated": peak,
                           "launches": launches}
            return out, launches, bodies

        ref_out, launches, bodies = record("forward", *_timed_run(
            torch, lambda: model.prefill(params, tokens, DIST_SEQ,
                                         paged=False)))
        _check_dist_run("reference forward (Model.prefill, paged=False)",
                        runs["forward"], launches, bodies, cfg.n_layers)
        ref_logits = ref_out[0]
        ref_cache = ref_out[1]["slot00"]

        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        fn = manual_tp.make_manual_prefill(cfg, mesh, DIST_BATCH, DIST_SEQ,
                                           tp=1)[0]
        shards = manual_tp.shard_params(cfg, params, 0, 1)
        (tp_logits, tp_cache), launches, bodies = record(
            "manual_tp", *_timed_run(torch, lambda: fn(shards, tokens)))
        _check_dist_run("manual-TP prefill (tp 1)", runs["manual_tp"],
                        launches, bodies, cfg.n_layers)
        total = dict(launches)
        runs["manual_tp"]["logits"] = _logits_vs(
            torch, "manual TP", tp_logits, ref_logits, cfg.vocab)
        kv_worst = 0.0
        for name in ("k", "v"):
            for layer in range(cfg.n_layers):
                want = ref_cache[name][layer].float()
                d = float((tp_cache[name][layer].float() - want).abs().max())
                lim = DIST_KV_REL * float(want.abs().max()) + DIST_KV_ATOL
                kv_worst = max(kv_worst, d / lim)
                if not math.isfinite(d) or d > lim:
                    raise AssertionError(f"DIST manual TP {name}[{layer}]: "
                                         f"{d} > {lim}")
        runs["manual_tp"]["kv_worst_over_limit"] = kv_worst
        log(f"  manual TP K/V: every layer within its limit ("
            f"{DIST_KV_REL:.4g}*max|layer| + {DIST_KV_ATOL}); worst at "
            f"{kv_worst:.3f} of it")
        del tp_cache, ref_cache, ref_out, shards
        gc.collect()
        torch.cuda.empty_cache()

        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("stage", "data", "model"))
        fn = pp_spmd.make_pp_prefill(cfg, mesh, DIST_BATCH, DIST_SEQ,
                                     n_stages=1, n_micro=DIST_MICRO)[0]
        stage = model.slice_stage_params(params, 1, 0)
        pp_logits, launches, bodies = record(
            "pipeline", *_timed_run(torch, lambda: fn(stage, tokens)))
        _check_dist_run(f"pipelined prefill (1 stage, {DIST_MICRO} "
                        f"micro-batches)", runs["pipeline"], launches,
                        bodies, cfg.n_layers * DIST_MICRO)
        total = {k: n + launches[k] + sum(r["launches"][k]
                                          for r in two.values())
                 for k, n in total.items()}
        runs["pipeline"]["logits"] = _logits_vs(
            torch, "pipeline", pp_logits, ref_logits, cfg.vocab)
    finally:
        dist.destroy_process_group()
    rec = {"device": smi, "model": "granite-3-8b", "layers": cfg.n_layers,
           "batch": DIST_BATCH, "seq": DIST_SEQ, "micro_batches": DIST_MICRO,
           "ranks": 1, "backend": "nccl", "runs": runs, "launches": total,
           "tp2": {"batch": DIST2_BATCH, "seq": DIST2_SEQ, "backend": "gloo",
                   "ranks": two},
           "limits": {"logits_rel": DIST_REL, "kv_rel": DIST_KV_REL,
                      "kv_atol": DIST_KV_ATOL},
           "phase_s": time.perf_counter() - t_phase}
    log(f"  DIST phase: {rec['phase_s']:.1f} s")
    log("DIST " + json.dumps(rec))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total, kernels


# ---------------------------------------------------------------------------
# phase 13: the reference's modes, append decode and causal_skip
# ---------------------------------------------------------------------------


APPEND_SKIP_TITLE = ("== the reference's modes: granite-3-8b at full width "
                     "and depth, slot-contiguous, scatter against append x "
                     "causal_skip (bf16, then float32)")
APPEND_LENS = DECODE_SHAPES["engine"]   # the serve's decode step, 16 tokens in
APPEND_PAIR_REL = 2 * ROW_REL   # two bf16 outputs, each within one row limit
APPEND_PAIR_ATOL = 2 * ROW_ATOL  # of the float32 sum: twice the limit apart
STATS_REL = 1e-5   # the stats against float32 sums of the same terms


def append_step_check(torch, flush):
    """One decode step of the append mode at full width (B 4, Hq 32 over
    Hkv 8, hd 128, bf16 strips of ``ENGINE_S`` rows, the history lengths
    ``APPEND_LENS``): ``decode_attention_with_stats``'s (out, m, l) over
    rows [0, pos) as plain torch on the card, and ``append_attention``'s
    merge of the new token at ``pos``. Held: m and l against float32 sums
    recomputed from the scores (``STATS_REL``); out / l against the
    contiguous decode kernel over [0, pos) and the merge against the
    kernel over [0, pos] with the token written, each row within
    ``APPEND_PAIR_REL`` of its largest |value| plus ``APPEND_PAIR_ATOL``
    (two bf16 outputs, each within one row limit of the float32 sum), and
    the merge against the float32 plain decode within one row limit.
    Times: the stats, the whole append step and the kernel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.models.attention import append_attention
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, s = len(APPEND_LENS), ENGINE_S

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = rnd(b, 1, Hq, HD), rnd(b, s, HKV, HD), rnd(b, s, HKV, HD)
    pos = torch.tensor(APPEND_LENS, dtype=torch.int32, device="cuda")
    rows = torch.arange(b, device="cuda")
    k_new = k[rows, pos.long()][:, None]
    v_new = v[rows, pos.long()][:, None]
    out, m, l = ref.decode_attention_with_stats(q, k, v, pos)
    g = Hq // HKV
    sc = (q.float().reshape(b, HKV, g, HD)
          @ k.float().permute(0, 2, 3, 1)) * ref.softmax_scale(HD)
    valid = (torch.arange(s, device="cuda")[None, :]
             < pos.long()[:, None])[:, None, None]
    m_want = sc.masked_fill(~valid, -math.inf).amax(-1)
    l_want = torch.exp(sc - m_want[..., None]).masked_fill(~valid, 0).sum(-1)
    errs = {}
    for name, got, want in (("m", m, m_want.reshape(b, Hq)),
                            ("l", l, l_want.reshape(b, Hq))):
        errs[name] = check(f"append stats {name} (tol {STATS_REL} of max)",
                           got, want, STATS_REL * float(want.abs().max()))

    def pair(name, got, want):
        d = (got.float() - want.float()).abs().amax(-1)
        lim = APPEND_PAIR_REL * want.float().abs().amax(-1) + APPEND_PAIR_ATOL
        ratio = float((d / lim).max())
        if not math.isfinite(ratio) or ratio > 1:
            raise AssertionError(f"{name}: a row at {ratio:.3f} of its limit")
        log(f"  {name}: max abs err {float(d.max()):.3e}, worst row at "
            f"{ratio:.3f} of its limit ({APPEND_PAIR_REL:.4g}*max|row| + "
            f"{APPEND_PAIR_ATOL})")
        return float(d.max()), ratio

    old = da.decode_attention(q, k, v, pos)
    errs["stats_vs_kernel"] = pair(
        "append stats out / l vs the decode kernel over [0, pos)",
        (out / l[:, None, :, None]).to(torch.bfloat16), old)
    merged = append_attention(q, k_new, v_new, k, v, pos)
    kernel = da.decode_attention(q, k, v, pos + 1)
    errs["merge_vs_kernel"] = pair(
        "append merge vs the decode kernel over [0, pos]", merged, kernel)
    errs["merge_vs_plain"] = check_rows(
        "append merge vs the float32 plain decode over [0, pos]", merged,
        ref.decode_attention_reference(q.float(), k.float(), v.float(),
                                       pos + 1))
    times = {
        "stats_ms": time_ms(torch, lambda: ref.decode_attention_with_stats(
            q, k, v, pos), flush=flush),
        "append_step_ms": time_ms(torch, lambda: append_attention(
            q, k_new, v_new, k, v, pos), flush=flush),
        "decode_kernel_ms": time_ms(torch, lambda: da.decode_attention(
            q, k, v, pos + 1), flush=flush)}
    log(f"  append step at B {b}, S {s}, kv_len {APPEND_LENS}: stats "
        f"{times['stats_ms']:.4f} ms, whole step {times['append_step_ms']:.4f}"
        f" ms (plain torch); the decode kernel {times['decode_kernel_ms']:.4f}"
        f" ms")
    return {"errors": errs, "times": times, "kv_len": APPEND_LENS, "S": s}


F32_TOL = 1e-5   # a float32 body against its float32 plain version


def f32_kernel_check(torch, prompts):
    """The float32 bodies that the float32 serves launch, at the serves'
    shapes (TF32 off: the CUDA-core bodies), each against its float32
    plain version to ``F32_TOL``: ``ops.flash_attention`` under
    causal_skip at batch 1, Sq = Sk = each prompt's length, Hq 32 over
    Hkv 8, hd 128, against ``ref.mha_reference``; the contiguous decode
    kernel at B 4 over ``ENGINE_S``-row strips at ``APPEND_LENS`` against
    ``ref.decode_attention_reference``; and the append step's merge
    against the same. Returns {check: max abs err}."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import append_attention
    gen = torch.Generator(device="cuda").manual_seed(14)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    errs = {}
    ops.set_attention_mode("causal_skip")
    try:
        for sq in sorted({len(p) for p in prompts}):
            q, k, v = rnd(1, sq, Hq, HD), rnd(1, sq, HKV, HD), \
                rnd(1, sq, HKV, HD)
            errs[f"flash_Sq{sq}"] = check(
                f"flash f32 Sq=Sk={sq}, Hq {Hq} over {HKV}, hd {HD}, "
                f"causal_skip", ops.flash_attention(q, k, v),
                ref.mha_reference(q, k, v), F32_TOL)
    finally:
        ops.set_attention_mode("masked_full")
    b, s = len(APPEND_LENS), ENGINE_S
    q, k, v = rnd(b, 1, Hq, HD), rnd(b, s, HKV, HD), rnd(b, s, HKV, HD)
    pos = torch.tensor(APPEND_LENS, dtype=torch.int32, device="cuda")
    want = ref.decode_attention_reference(q, k, v, pos + 1)
    errs["decode"] = check(
        f"decode (contiguous) f32, B {b} over {s}-row strips, kv_len "
        f"{[n + 1 for n in APPEND_LENS]}", da.decode_attention(q, k, v,
                                                              pos + 1),
        want, F32_TOL)
    rows = torch.arange(b, device="cuda")
    errs["append_merge"] = check(
        "append merge f32 over [0, pos]", append_attention(
            q, k[rows, pos.long()][:, None], v[rows, pos.long()][:, None],
            k, v, pos), want, F32_TOL)
    return errs


def capture_decode_logits(engine):
    """Keep every decode step's logits as ``engine`` picks its tokens from
    them: ``runner.decode`` wrapped to hold (not copy) the tensor it
    returns, beside (rid, slot, index of the token the step emits) for
    each request it decodes. Host bookkeeping only: no launch, no sync."""
    runner = engine.runner
    inner, steps = runner.decode, []

    def decode(reqs, skip_slots=()):
        h = inner(reqs, skip_slots=skip_slots)
        steps.append(([(r.rid, r.slot, len(r.generated)) for r in reqs], h))
        return h

    runner.decode = decode
    return steps


MODE_SHIFT_REL = 2.0 ** -5   # the modes' logit shift, of the row's max |logit|


def mode_parting(captured, streams, vocab):
    """Scatter's and append's streams read from the serves' own logits
    (``capture_decode_logits``), over the decode steps the streams share
    (up to and with the step where they part). Held: each captured row's
    argmax is the token its serve emitted, so these are the logits the
    streams came from; the mode shift max|scatter - append| of a row stays
    within ``MODE_SHIFT_REL`` of its largest |logit|; where the streams
    part, the scatter logits of the two tokens emitted there are no
    further apart than that step's shift, so the modes' rounding alone
    can swap them. Reported per request: the scatter top-2 margins and
    the shifts, how many steps had a margin at or under the shift, the
    worst shift over its limit, and at the parting step both serves'
    logits of the two tokens."""
    rows = {}
    for key, steps in captured.items():
        rids = sorted({rid for ent, _ in steps for rid, _, _ in ent})
        rows[key] = {(rids.index(rid), j): h[slot, 0]
                     for ent, h in steps for rid, slot, j in ent}
    sc, ap = rows["masked_full x scatter"], rows["causal_skip x append"]
    tokens = {key: {} for key in rows}
    for key, r in rows.items():
        for (i, j), h in r.items():
            tokens[key][(i, j)] = int(h.argmax())
            if tokens[key][(i, j)] != streams[key][i][j]:
                raise AssertionError(f"{key}: request {i}'s captured logits "
                                     f"at token {j} are not its serve's")
    records = []
    for i in sorted({i for i, _ in sc}):
        steps = sorted(j for ii, j in sc if ii == i)
        parted, margins, shifts, worst = None, [], [], 0.0
        for j in steps:
            if (i, j) not in ap:
                break
            ls, la = sc[(i, j)][:vocab].float(), ap[(i, j)][:vocab].float()
            top2 = ls.topk(2).values
            margins.append(float(top2[0] - top2[1]))
            shifts.append(float((ls - la).abs().max()))
            worst = max(worst, shifts[-1] / (MODE_SHIFT_REL
                                             * float(ls.abs().max())))
            if not worst <= 1:
                raise AssertionError(f"request {i} token {j}: the modes move "
                                     f"the logits {worst:.3f} of their limit")
            ts, ta = tokens["masked_full x scatter"][(i, j)], \
                tokens["causal_skip x append"][(i, j)]
            if ts != ta:
                if float(ls[ts] - ls[ta]) > shifts[-1]:
                    raise AssertionError(
                        f"request {i} parts at token {j} where scatter's "
                        f"logits {float(ls[ts])}, {float(ls[ta])} are "
                        f"further apart than the shift {shifts[-1]}")
                parted = {"token": j, "scatter_token": ts,
                          "append_token": ta,
                          "scatter_logits": [float(ls[ts]), float(ls[ta])],
                          "append_logits": [float(la[ts]), float(la[ta])],
                          "shift": shifts[-1]}
                break
        near = sum(m <= d for m, d in zip(margins, shifts))
        records.append({
            "request": i, "steps_compared": len(margins),
            "steps_margin_within_shift": near,
            "min_margin": min(margins), "max_shift": max(shifts),
            "median_shift": sorted(shifts)[len(shifts) // 2],
            "worst_shift_over_limit": worst, "parted": parted})
    return records


def append_skip_serve(torch, cfg, params, prompts, label):
    """The same requests through ``Engine(paged=False)`` under scatter and
    under append x causal_skip (the modes put back after), each with its
    launches counted from 0 just before its serve and read just after, four
    of its decode steps profiled, and CUDA events around the whole serve.
    Returns ({mode: record}, where a record holds its streams; {mode: its
    serve's decode logits, ``capture_decode_logits``})."""
    from repro_torch.kernels import ops
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine
    runs, captured = {}, {}
    try:
        for attn_mode, dec_mode in (("masked_full", "scatter"),
                                    ("causal_skip", "append")):
            ops.set_attention_mode(attn_mode)
            ops.set_decode_mode(dec_mode)
            eng = Engine(cfg, [params], paged=False, device="cuda",
                         **SERVE_KW)
            logits = capture_decode_logits(eng)
            ep = ServingEndpoint(eng)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            streams, steps, prof = drive(torch, ep, prompts,
                                         profile_at=PROFILE_AT)
            ev1.record()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            bodies = ops.body_counts()
            del ep, eng
            if counts["flash_attention"] <= 0:
                raise AssertionError(f"{label} {dec_mode}: flash never "
                                     f"launched")
            if (counts["decode_attention"] > 0) != (dec_mode == "scatter"):
                raise AssertionError(f"{label} {dec_mode}: decode kernel "
                                     f"launched {counts['decode_attention']}"
                                     f" times")
            if any(counts[k] for k in ("ragged_paged_attention",
                                       "ragged_paged_attention_q8",
                                       "paged_decode_attention", "wkv6")):
                raise AssertionError(f"{label} {dec_mode}: {counts}")
            if cfg.dtype == "bfloat16":
                check_bodies(counts, f"{label} {dec_mode}")
            if not all(len(t) == MAX_NEW and all(0 <= x < cfg.vocab
                                                 for x in t)
                       for t in streams):
                raise AssertionError(f"{label} {dec_mode}: bad streams")
            key = f"{attn_mode} x {dec_mode}"
            runs[key] = {"streams": streams, "launches": counts,
                         "bodies": bodies, "serve": step_stats(steps),
                         "serve_device_clock_ms": ev0.elapsed_time(ev1),
                         "profile": prof}
            captured[key] = logits
            log(f"  {label} {key}: flash launches {counts['flash_attention']}"
                f", decode kernel {counts['decode_attention']}; serve "
                f"{runs[key]['serve_device_clock_ms']:.1f} ms between CUDA "
                f"events; {prof['steps']} decode steps profiled: device "
                f"{prof['device_ms_per_step']:.2f} ms a step (profiled wall "
                f"{prof['profiled_wall_ms_per_step']:.2f} ms); decode step "
                f"p50 {runs[key]['serve']['decode_step_ms_p50']:.2f} ms")
    finally:
        ops.set_attention_mode("masked_full")
        ops.set_decode_mode("scatter")
    return runs, captured


def append_skip_phase(torch, smi, prompts):
    """The ``APPEND_SKIP`` phase: granite-3-8b at full width and depth (the
    ``COLDSTART`` phase's) on the slot-contiguous layout, random weights
    from a seeded generator. First one append decode step against the
    contiguous decode kernel (``append_step_check``). Then the four
    requests through ``Engine(paged=False)`` under scatter (masked_full)
    and under append x causal_skip, in the config's bf16 and with the same
    weights in float32 (TF32 off: the kernels' CUDA-core bodies, held
    first at the serves' shapes by ``f32_kernel_check``). Held: flash
    launched under both modes (the kernel under causal_skip, as the
    reference's Pallas branch), the decode kernel under scatter only, the
    paged kernels never, bf16 launches on the tensor cores; float32
    streams equal token for token; both dtypes' streams read from the
    serves' own logits (``mode_parting``): the modes' logit shift within
    2^-5 of a row's largest |logit|, and bf16 streams part only where the
    two tokens' scatter logits lie within that step's shift (the modes
    round to bf16 at other points, so such a pair can go either way;
    the agreement is reported). Returns (the append x causal_skip serves'
    launches, bf16 and float32 summed; the record)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model
    t_phase = time.perf_counter()
    cfg = get_config("granite-3-8b")
    assert cfg.n_layers == 40 and cfg.dtype == "bfloat16", cfg
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    step = append_step_check(torch, flush)
    del flush
    f32_errs = f32_kernel_check(torch, prompts)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    serves, parting = {}, {}
    for label in ("bf16", "f32"):
        if label == "f32":
            f32 = tree_map(lambda a: a.float(), params)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            params, cfg = f32, dataclasses.replace(cfg, dtype="float32")
            del f32
        serves[label], captured = append_skip_serve(torch, cfg, params,
                                                    prompts, label)
        parting[label] = mode_parting(
            captured, {k: r["streams"] for k, r in serves[label].items()},
            cfg.vocab)
        del captured
        for rec in parting[label]:
            log(f"  {label} scatter vs append x causal_skip, the serves' "
                f"logits: {rec}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    sc, ap = (serves["bf16"][k]["streams"] for k in (
        "masked_full x scatter", "causal_skip x append"))
    agree = sum(x == y for s, r in zip(sc, ap)
                for x, y in zip(s, r)) / sum(len(s) for s in sc)
    log(f"  bf16 append x causal_skip streams agree with scatter's on "
        f"{agree:.3f} of tokens (reported)")
    sc32, ap32 = (serves["f32"][k]["streams"] for k in (
        "masked_full x scatter", "causal_skip x append"))
    if sc32 != ap32:
        raise AssertionError(f"APPEND_SKIP float32: append x causal_skip "
                             f"streams differ from scatter's:\n{sc32}\n"
                             f"{ap32}")
    log(f"  f32 streams: append x causal_skip == scatter, token for token "
        f"(first request: {sc32[0][:8]} ...)")
    launches = {}
    for runs in serves.values():
        for k, n in runs["causal_skip x append"]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    rec = {"device": smi, "model": "granite-3-8b", "layers": cfg.n_layers,
           "step_check": step, "f32_kernel_errors": f32_errs,
           "serves": serves, "bf16_token_agreement": agree,
           "parting": parting, "f32_streams_equal": True,
           "launches_append_skip": launches,
           "limits": {"pair_rel": APPEND_PAIR_REL,
                      "pair_atol": APPEND_PAIR_ATOL, "row_rel": ROW_REL,
                      "row_atol": ROW_ATOL, "stats_rel": STATS_REL,
                      "f32": F32_TOL, "mode_shift_rel": MODE_SHIFT_REL},
           "phase_s": time.perf_counter() - t_phase}
    log(f"  APPEND_SKIP phase: {rec['phase_s']:.1f} s")
    log("APPEND_SKIP " + json.dumps(rec))
    return launches, rec


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------


KERNELS = [
    ("ragged_paged_attention", "src/repro_torch/csrc/ragged_paged_attention.cu",
     "src/repro/kernels/ragged_attention.py:105"),
    ("ragged_paged_attention_q8",
     "src/repro_torch/csrc/ragged_paged_attention.cu",
     "src/repro/kernels/ragged_attention.py:105"),
    ("paged_decode_attention", "src/repro_torch/csrc/paged_decode_attention.cu",
     "src/repro/kernels/decode_attention.py:154"),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:69"),
    ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention.py:85"),
    ("wkv6", "src/repro_torch/csrc/wkv6.cu", "src/repro/kernels/wkv6.py:66"),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--prefill-profile", action="store_true",
                    help="build, then only profile one granite-3-8b prefill "
                         "on each layout and one rwkv6-1.6b prefill (no "
                         "result line)")
    ap.add_argument("--decode-shape", action="store_true",
                    help="build, then only time both decode kernels at the "
                         "engine's decode step (no result line)")
    ap.add_argument("--wkv6-shape", action="store_true",
                    help="build, then only check and time the wkv6 kernel "
                         "at rwkv6-1.6b's prefill and decode shapes (no "
                         "result line)")
    ap.add_argument("--tier", action="store_true",
                    help="build, then only the KV tier, routing and "
                         "sanitizer phase (no result line)")
    ap.add_argument("--fleet", action="store_true",
                    help="build, then only the fleet phase (no result "
                         "line)")
    ap.add_argument("--families", action="store_true",
                    help="build, then only the sparse-expert and Mamba "
                         "phase (no result line)")
    ap.add_argument("--encdec-vlm", action="store_true",
                    help="build, then only the encoder-decoder and image "
                         "prefix phase (no result line)")
    ap.add_argument("--train", action="store_true",
                    help="build, then only the training phase (no result "
                         "line)")
    ap.add_argument("--dist", action="store_true",
                    help="build, then only the distributed-prefill phase "
                         "(no result line)")
    ap.add_argument("--append-skip", action="store_true",
                    help="build, then only the append x causal_skip phase "
                         "(no result line)")
    ap.add_argument("--dist-rank", nargs=2, metavar=("RANK", "PORT"),
                    help=argparse.SUPPRESS)  # one rank of dist_two_ranks
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false: this "
                         "smoke test runs on the card only")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit(f"FAIL: {SRC / 'repro_torch'} not found: run "
                         f"from the root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    global BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S
    from repro_torch.roofline.analysis import (  # noqa: F401
        BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S)
    # full-precision float32 products for the f32 checks (both defaults,
    # stated and set)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dist_rank:
        dist_rank(torch, int(args.dist_rank[0]), args.dist_rank[1])
        return

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    log("== build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", text))
        log(f"  {name}: {len(regs)} kernels, at most {max(regs)} registers "
            f"a thread, {spills} bytes of spill stores and loads (ptxas)")

    if args.prefill_profile:
        log("== prefill profiles (granite-3-8b, then rwkv6-1.6b; 412 "
            "tokens, full depth)")
        prefill_profile_phase(torch)
        return
    if args.decode_shape:
        log("== decode kernels at the engine's decode step")
        decode_shape_phase(torch, 20, torch.empty(64 << 20, dtype=torch.uint8,
                                                  device="cuda"))
        return
    if args.wkv6_shape:
        log("== wkv6 at rwkv6-1.6b's prefill and decode shapes")
        wkv6_checks(torch, 20, torch.empty(64 << 20, dtype=torch.uint8,
                                           device="cuda"))
        return
    if args.tier:
        log("== KV tiers, routing and the sanitizer (granite-3-8b, full "
            "width and depth, paged)")
        tier_phase(torch)
        return
    if args.fleet:
        log("== the fleet: granite-3-8b and rwkv6-1.6b at full width and "
            "depth behind one FleetFrontend")
        fleet_phase(torch)
        return
    if args.families:
        log(FAMILIES_TITLE)
        families_phase(torch)
        return
    if args.encdec_vlm:
        log(ENCDEC_VLM_TITLE)
        encdec_vlm_phase(torch)
        return
    if args.train:
        log(TRAIN_TITLE)
        train_phase(torch, smi)
        return
    if args.dist:
        log(DIST_TITLE)
        dist_phase(torch, smi)
        return
    if args.append_skip:
        from repro_torch.configs import get_config
        log(APPEND_SKIP_TITLE)
        append_skip_phase(torch, smi,
                          main_prompts(get_config("granite-3-8b").vocab))
        return

    phase_times = {}

    def phase(name, fn, *a):
        """``fn(*a)`` timed: CUDA events around it (the device clock from
        its first enqueue to its last, idle gaps included) and the wall
        clock; logged and kept for the ``PHASES`` line."""
        import gc
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        out = fn(*a)
        ev1.record()
        torch.cuda.synchronize()
        phase_times[name] = {"device_clock_ms": ev0.elapsed_time(ev1),
                             "wall_s": time.perf_counter() - t0}
        log(f"  phase {name}: {phase_times[name]['device_clock_ms']:.1f} ms "
            f"between CUDA events, {phase_times[name]['wall_s']:.1f} s wall")
        gc.collect()
        torch.cuda.empty_cache()
        return out

    log("== kernels vs plain versions")
    rows = phase("kernels", kernel_phase, torch, args.quick)

    launches = {k: None for k in rows}
    fleet_launches = {k: None for k in rows}
    families_launches = {k: None for k in rows}
    encdec_vlm_launches = {k: None for k in rows}
    train_launches = {k: None for k in rows}
    dist_launches = {k: None for k in rows}
    append_skip_launches = {k: None for k in rows}
    g1, encdec_vlm, train_kernel_row, dist_rows = {}, {}, None, None
    append_step = None
    if not args.quick:
        from repro_torch.configs import get_config
        prompts = main_prompts(get_config("granite-3-8b").vocab)
        log("== serve granite-3-8b at full width (paged layout)")
        launches.update(phase("SERVE", serve_phase, torch))
        log("== cold start through the ServerlessFrontend at full width "
            "and depth (slot-contiguous layout)")
        launches.update(phase("COLDSTART", coldstart_phase, torch, prompts))
        log("== rwkv6-1.6b cold start through the ServerlessFrontend at full "
            "width and depth (the wkv6 kernel's path)")
        launches.update(phase("RWKV", rwkv_phase, torch))
        log("== disk tier: cold deploy from an on-disk store (full width, "
            "4 layers)")
        phase("DISK", disk_tier_phase, torch, prompts)
        log("== KV tiers, routing and the sanitizer (granite-3-8b, full "
            "width and depth, paged)")
        phase("TIER", tier_phase, torch)
        log("== the fleet: granite-3-8b and rwkv6-1.6b at full width and "
            "depth behind one FleetFrontend")
        fleet_launches = {k: 0 for k in rows}
        fleet_launches.update(phase("FLEET", fleet_phase, torch))
        log(FAMILIES_TITLE)
        fam, g1 = phase("FAMILIES", families_phase, torch)
        families_launches = {k: fam.get(k, 0) for k in rows}
        log(ENCDEC_VLM_TITLE)
        ev, encdec_vlm = phase("ENCDEC_VLM", encdec_vlm_phase, torch)
        encdec_vlm_launches = {k: ev.get(k, 0) for k in rows}
        log(TRAIN_TITLE)
        tr, train_kernel_row = phase("TRAIN", train_phase, torch, smi)
        train_launches = {k: tr.get(k, 0) for k in rows}
        log(DIST_TITLE)
        di, dist_rows = phase("DIST", dist_phase, torch, smi)
        dist_launches = {k: di.get(k, 0) for k in rows}
        log(APPEND_SKIP_TITLE)
        ap, append_rec = phase("APPEND_SKIP", append_skip_phase, torch, smi,
                               prompts)
        append_skip_launches = {k: ap.get(k, 0) for k in rows}
        append_step = append_rec["step_check"]
    log("PHASES " + json.dumps(phase_times))

    kernels = []
    for name, source, replaces in KERNELS:
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "launches_fleet": fleet_launches[name],
                        "launches_families": families_launches[name],
                        "launches_encdec_vlm": encdec_vlm_launches[name],
                        "launches_train": train_launches[name],
                        "launches_dist": dist_launches[name],
                        "launches_append_skip": append_skip_launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "err_over_tol": r["err_over_tol"],
                        **{k: r[k] for k in FLASH_STATS + RAGGED_STATS
                           + DECODE_STATS if k in r},
                        "g1": ({k: g1[name][k] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "max_abs_err", *FLASH_STATS,
                            *RAGGED_STATS, *DECODE_STATS)
                            if k in g1[name]}
                            if name in g1 else None),
                        "encdec_vlm": {label: {k: r[k] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "max_abs_err", *FLASH_STATS,
                            *RAGGED_STATS)
                            if k in r}
                            for label, r in encdec_vlm.items()
                            if r["kernel"] == name},
                        "train": (train_kernel_row if name == "flash_attention"
                                  else None),
                        "dist": (dist_rows if name == "flash_attention"
                                 else None),
                        "append_step": (append_step
                                        if name == "decode_attention"
                                        else None)})
    # every pl.pallas_call of the repo has its kernel above
    print(json.dumps({"kernels": kernels, "not_ported": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
