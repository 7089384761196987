"""Plain PyTorch versions of the hand-written kernels: the CPU path of
``kernels/ops.py`` and the yardstick ``chip_smoke.py`` holds each CUDA
kernel against on the card.

Shapes follow the reference (``src/repro/kernels/ref.py``):
  q          (B, Sq, Hq, hd)         ragged: (T, Hq, hd)
  k, v       (B, Sk, Hkv, hd)        slot-contiguous caches / prompt K/V
  pages      (N, bs, Hkv, hd)        Hq % Hkv == 0 (GQA), head hq reads
                                     kv head hq // (Hq // Hkv)
  kv_len     (B,) int32 valid cache length per sequence

Scores, softmax and accumulation run in float32 and the output is cast to
q's dtype. A masked key takes no part in the sum (its probability is
zeroed before the product), and a row with no valid key at all (a pad
token, ``kv_len == 0``) comes back exactly 0: ``acc / max(l, 1e-30)``.

Beside the kernels' plain versions stand three of the reference's oracles
that no kernel replaces: ``flash_attention_blocked`` and
``flash_attention_blocked_skip``, the plain path of ``ops.flash_attention``
for long sequences on the CPU (the online softmax over key blocks), and
``decode_attention_with_stats``, the ``append`` decode mode's attention over
the old cache, which runs as plain PyTorch on the CPU and on the card alike.

The last section is RWKV6's recurrence (``wkv6``): r, k, v, w (B, T, H, hd),
u (H, hd), a float32 state (B, H, hd, hd) per sequence.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def softmax_scale(hd: int) -> float:
    """The attention score scale, 1/sqrt(head_dim): the one place the
    kernels' wrappers and the plain versions take it from."""
    return 1.0 / math.sqrt(hd)


def _masked_softmax_av(s, mask, v):
    """s (..., Lq, L) f32 scores, mask (..., Lq, L) bool, v (..., L, hd)
    f32 -> (..., Lq, hd). The online-softmax finish of the kernels written
    in one pass: masked keys get p = 0, and a fully masked row is 0."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return (p @ v) / torch.clamp_min(l, 1e-30)


# ---------------------------------------------------------------------------
# Attention over slot-contiguous K/V: prefill (flash) and decode.
# ---------------------------------------------------------------------------


def mha_reference(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  kv_len=None):
    """Plain version of ``flash_attention``.

    q (B,Sq,Hq,hd); k, v (B,Sk,Hkv,hd). Query position t (absolute
    ``q_offset + t``) attends keys kpos < Sk and, when ``causal``,
    kpos <= q_offset + t; ``kv_len`` (B,) further masks kpos >= kv_len[b].
    Unlike the reference's oracle of the same name, a row with no valid key
    comes back exactly 0 (as the kernels give it), not a uniform average."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qs = q.float().reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]         # (B,Hkv,1,Sk,hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qs @ kf.transpose(-1, -2)) * softmax_scale(hd)    # (B,Hkv,G,Sq,Sk)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = kpos[None, :] <= qpos[:, None]
    mask = mask[None].expand(b, sq, sk)
    if kv_len is not None:
        mask = mask & (kpos[None, None, :] < kv_len.long()[:, None, None])
    o = _masked_softmax_av(s, mask[:, None, None], vf)     # (B,Hkv,G,Sq,hd)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def decode_attention_reference(q, k_cache, v_cache, kv_len):
    """Plain version of ``decode_attention``: q (B,1,Hq,hd) against
    slot-contiguous caches (B,S,Hkv,hd), over each row's first ``kv_len``
    positions; a row with kv_len 0 is exactly 0."""
    return mha_reference(q, k_cache, v_cache, causal=False, kv_len=kv_len)


def decode_attention_with_stats(q, k_cache, v_cache, kv_len, *, scale=None):
    """Decode attention that also returns the softmax stats, so a new
    token's contribution can be merged in without writing it to the cache
    first (the ``append`` decode mode, ``models/attention.py``).

    q (B,1,Hq,hd); caches (B,S,Hkv,hd); kv_len (B,). Returns (out
    (B,1,Hq,hd), m (B,Hq), l (B,Hq)), all float32: ``out`` is the
    *unnormalised* sum of p * v over the row's first ``kv_len`` positions,
    m the row's largest score and l the sum of p = exp(s - m). A row with
    kv_len 0 gives out 0, m = ``NEG_INF`` and l 0, as the reference's."""
    b, _, hq, hd = q.shape
    sk, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = softmax_scale(hd) if scale is None else scale
    qs = q.float().reshape(b, hkv, g, hd)[:, :, :, None]   # (B,Hkv,G,1,hd)
    kf = k_cache.float().permute(0, 2, 1, 3)[:, :, None]   # (B,Hkv,1,S,hd)
    vf = v_cache.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qs @ kf.transpose(-1, -2)) * scale                # (B,Hkv,G,1,S)
    valid = (torch.arange(sk, device=q.device)[None, :]
             < kv_len.long()[:, None])[:, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                     # (B,Hkv,G,1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    out = (p @ vf).reshape(b, hq, 1, hd).transpose(1, 2)   # (B,1,Hq,hd)
    return out, m.reshape(b, hq), p.sum(dim=-1).reshape(b, hq)


# ---------------------------------------------------------------------------
# Blocked attention: the online-softmax recurrence over key blocks, the
# plain path of ``ops.flash_attention`` on the CPU for long sequences.
# ---------------------------------------------------------------------------


def _attend_blocks(qs, qpos, kf, vf, kv_limit, kb, n_kv, causal, scale):
    """One query block against key blocks [0, n_kv) of ``kb`` positions.

    qs (B,Hkv,G,nq,hd) f32; qpos (nq,) absolute query positions; kf, vf
    (B,Hkv,Sk,hd) f32; kv_limit (B,) keys at or past it are masked.
    Returns (B,Hkv,G,nq,hd): acc / max(l, 1e-30), float32. A masked key's
    p is 0, so a query with no valid key at all comes back 0."""
    b, hkv, g, nq, hd = qs.shape
    m = qs.new_full((b, hkv, g, nq), NEG_INF)
    l = qs.new_zeros((b, hkv, g, nq))
    acc = qs.new_zeros((b, hkv, g, nq, hd))
    for ki in range(n_kv):
        k0 = ki * kb
        kblk = kf[:, :, None, k0:k0 + kb]                  # (B,Hkv,1,kb,hd)
        vblk = vf[:, :, None, k0:k0 + kb]
        kpos = torch.arange(k0, k0 + kblk.shape[3], device=qs.device)
        s = (qs @ kblk.transpose(-1, -2)) * scale          # (B,Hkv,G,nq,kb)
        msk = (kpos[None, :] < kv_limit[:, None])[:, None, None, None]
        if causal:
            msk = msk & (kpos[None, :] <= qpos[:, None])
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vblk
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def _blocked(q, k, v, causal, q_offset, kv_len, q_block, kv_block, scale,
             skip):
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = softmax_scale(hd) if scale is None else scale
    qb, kb = min(q_block, sq), min(kv_block, sk)
    n_kv = -(-sk // kb)
    kf = k.float().permute(0, 2, 1, 3)                     # (B,Hkv,Sk,hd)
    vf = v.float().permute(0, 2, 1, 3)
    qs = q.float().reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kv_limit = (torch.full((b,), sk, device=q.device) if kv_len is None
                else kv_len.long())
    outs = []
    for qi in range(-(-sq // qb)):
        q0 = qi * qb
        qpos = torch.arange(q0, min(q0 + qb, sq), device=q.device) + q_offset
        # the skip leaves out the key blocks wholly above this query block's
        # diagonal (its padded end, as the reference counts it)
        nk = min(-(-((qi + 1) * qb + q_offset) // kb), n_kv) if skip \
            else n_kv
        outs.append(_attend_blocks(qs[:, :, :, q0:q0 + qb], qpos, kf, vf,
                                   kv_limit, kb, nk, causal, scale))
    o = torch.cat(outs, dim=3)                             # (B,Hkv,G,Sq,hd)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def flash_attention_blocked(q, k, v, *, causal: bool = True,
                            q_offset: int = 0, kv_len=None,
                            q_block: int = 512, kv_block: int = 1024,
                            scale=None):
    """Blocked attention: each block of ``q_block`` queries walks every
    block of ``kv_block`` keys with the online softmax, in float32, so no
    (Sq, Sk) score matrix is ever held. The same mask as
    :func:`mha_reference` (causal from ``q_offset``, and ``kv_len`` (B,));
    the output in q's dtype. A query with no valid key comes back 0."""
    return _blocked(q, k, v, causal, q_offset, kv_len, q_block, kv_block,
                    scale, skip=False)


def flash_attention_blocked_skip(q, k, v, *, q_offset: int = 0, kv_len=None,
                                 q_block: int = 2048, kv_block: int = 2048,
                                 scale=None):
    """Causal :func:`flash_attention_blocked` that skips the key blocks
    wholly above the diagonal: query block i walks key blocks up to
    ceil(((i + 1) * q_block + q_offset) / kv_block) only, about half the
    score work of the masked walk at ``q_offset`` 0."""
    return _blocked(q, k, v, True, q_offset, kv_len, q_block, kv_block,
                    scale, skip=True)


# ---------------------------------------------------------------------------
# int8 KV page quantization (per-row, per-KV-head, asymmetric).
# ---------------------------------------------------------------------------


def quantize_kv(x):
    """Quantize KV rows to int8 along the head_dim axis.

    x (..., Hkv, hd) float -> (q int8, scale f32 (..., Hkv), zero f32
    (..., Hkv)) with x ~= q * scale + zero: zero = midrange, scale =
    range / 254. ``torch.round`` rounds half to even like ``jnp.round``, so
    the bytes, scales and zeros equal the reference's."""
    xf = x.float()
    mx = xf.amax(dim=-1)
    mn = xf.amin(dim=-1)
    zero = (mx + mn) * 0.5
    scale = torch.clamp_min(mx - mn, 1e-8) / 254.0
    q = torch.clamp(torch.round((xf - zero[..., None]) / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale, zero


def dequantize_kv(q, scale, zero):
    """Inverse of :func:`quantize_kv`: (..., Hkv, hd) f32."""
    return q.float() * scale[..., None] + zero[..., None]


# ---------------------------------------------------------------------------
# Ragged-batch paged attention: one pass over a whole mixed step.
# ---------------------------------------------------------------------------


def _gather_rows(pages, table_row, n_rows):
    """Rows [0, n_rows) of one sequence from the pool: (n_rows, ...)."""
    bs = pages.shape[1]
    pos = torch.arange(n_rows, device=pages.device)
    flat = pages.reshape((-1,) + tuple(pages.shape[2:]))
    return flat[table_row[pos // bs].long() * bs + pos % bs]


def ragged_paged_attention_reference(q, k_pages, v_pages, tables, row, pos,
                                     *, kv_quant=None):
    """Plain version of ``ragged_paged_attention``.

    q (T,Hq,hd) — the step's query tokens flattened across requests;
    pages (N,bs,Hkv,hd); tables (B,nb) int32 page ids; row (T,) int32
    block-table row of each token; pos (T,) int32 absolute position
    (-1 = pad). Token t attends over kv positions [0, pos[t]] of its row's
    pages; pad tokens return exactly 0. ``kv_quant`` ({k,v}_{scale,zero}
    pools (N,bs,Hkv) f32) dequantizes int8 pages at load.

    Each distinct table row's span is gathered once (up to its tokens'
    largest position) and its tokens attend over it, so no per-token copy
    of the history is made."""
    t, hq, hd = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    scale = softmax_scale(hd)
    out = torch.zeros((t, hq, hd), dtype=torch.float32, device=q.device)
    row = row.long()
    pos = pos.long()
    live = pos >= 0
    for r in torch.unique(row[live]).tolist():
        sel = torch.nonzero(live & (row == r)).flatten()
        n = int(pos[sel].max()) + 1
        kf = _gather_rows(k_pages, tables[r], n)          # (n,Hkv,hd)
        vf = _gather_rows(v_pages, tables[r], n)
        if kv_quant is not None:
            kf = dequantize_kv(kf, _gather_rows(kv_quant["k_scale"],
                                                tables[r], n),
                               _gather_rows(kv_quant["k_zero"], tables[r], n))
            vf = dequantize_kv(vf, _gather_rows(kv_quant["v_scale"],
                                                tables[r], n),
                               _gather_rows(kv_quant["v_zero"], tables[r], n))
        kf = kf.float().permute(1, 0, 2)[:, None]          # (Hkv,1,n,hd)
        vf = vf.float().permute(1, 0, 2)[:, None]
        qs = q[sel].float().reshape(-1, hkv, g, hd).permute(1, 2, 0, 3)
        s = (qs @ kf.transpose(-1, -2)) * scale            # (Hkv,G,tr,n)
        mask = (torch.arange(n, device=q.device)[None, :]
                <= pos[sel][:, None])                      # (tr, n)
        o = _masked_softmax_av(s, mask[None, None], vf)    # (Hkv,G,tr,hd)
        out[sel] = o.permute(2, 0, 1, 3).reshape(-1, hq, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Paged decode attention: one new token per sequence against the pool.
# ---------------------------------------------------------------------------


def paged_decode_attention_reference(q, k_pages, v_pages, block_tables,
                                     kv_len):
    """Plain version of ``paged_decode_attention``.

    q (B,1,Hq,hd); pages (N,bs,Hkv,hd) shared pool; block_tables (B,nb)
    int32 page ids; kv_len (B,) valid lengths. Table entries past a
    sequence's ``kv_len`` may name any valid page: the mask drops them."""
    b, one, hq, hd = q.shape
    n_pages, bs, hkv, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = hq // hkv
    scale = softmax_scale(hd)
    idx = (block_tables.long()[:, :, None] * bs
           + torch.arange(bs, device=q.device)).reshape(b, nb * bs)
    kf = k_pages.reshape(n_pages * bs, hkv, hd)[idx].float()  # (B,L,Hkv,hd)
    vf = v_pages.reshape(n_pages * bs, hkv, hd)[idx].float()
    qs = q[:, 0].float().reshape(b, hkv, g, hd)               # (B,Hkv,G,hd)
    s = (qs @ kf.permute(0, 2, 3, 1)) * scale                 # (B,Hkv,G,L)
    mask = (torch.arange(nb * bs, device=q.device)[None, :]
            < kv_len.long()[:, None])                         # (B, L)
    out = _masked_softmax_av(s, mask[:, None, None, :],
                             vf.permute(0, 2, 1, 3))          # (B,Hkv,G,hd)
    return out.reshape(b, 1, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# WKV6 (RWKV6 'Finch') recurrence, per (batch, head), sequential in time:
#   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
#   S_t = diag(exp(-exp(w_t))) S_{t-1} + k_t v_t^T
# ---------------------------------------------------------------------------


def wkv6_reference(r, k, v, w, u, initial_state=None):
    """Plain version of ``wkv6``: a loop over t in float32.

    r, k, v, w (B,T,H,hd); u (H,hd); initial_state (B,H,hd,hd) float32 or
    None (zeros). Row i of a head's state is key channel i, column j value
    channel j. Returns (y (B,T,H,hd) in r's dtype, final state (B,H,hd,hd)
    float32)."""
    b, t, h, n = r.shape
    f32 = torch.float32
    S = (torch.zeros((b, h, n, n), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)[None, :, :, None]                       # (1,H,hd,1)
    ys = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]   # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, i], S + uf * kv))
        S = torch.exp(-torch.exp(wf[:, i]))[..., None] * S + kv
    y = torch.stack(ys, 1) if ys else rf.new_zeros((b, 0, h, n))
    return y.to(r.dtype), S


def wkv6_chunked(r, k, v, w, u, initial_state=None, chunk: int = 64):
    """The reference's chunked form of the same recurrence (its TPU kernel's
    layout): T padded to a multiple of ``chunk`` (r/k/v with 0, w with -1e9,
    so a padded step leaves the state as it was), then one
    ``wkv6_reference`` per chunk carrying the state."""
    b, t, h, n = r.shape
    if t <= chunk:
        return wkv6_reference(r, k, v, w, u, initial_state)
    pad = (-t) % chunk
    rf, kf, vf, wf = (x.to(torch.float32) for x in (r, k, v, w))
    if pad:
        def grow(x, value):
            return torch.cat([x, x.new_full((b, pad, h, n), value)], dim=1)
        rf, kf, vf = (grow(x, 0.0) for x in (rf, kf, vf))
        wf = grow(wf, -1e9)
    S, ys = initial_state, []
    for c0 in range(0, t + pad, chunk):
        sl = slice(c0, c0 + chunk)
        y, S = wkv6_reference(rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl], u,
                              S)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t].to(r.dtype), S
