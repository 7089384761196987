"""Kernel dispatch layer: by the device of the tensors.

Models call these wrappers. A CPU tensor takes the kernel's plain PyTorch
version (``kernels/ref.py``); a CUDA tensor takes the hand-written CUDA
kernel, which launches or raises. There is no switch that runs the plain
version on the card. A tensor on the ``meta`` device (the dry run's shapes,
``launch/``) also takes the plain version, which there computes shapes and
dtypes only, no arithmetic, and counts no launch.

Each kernel counts its launches (``launch_counts``), so a run can show
that its attention and its recurrences went through the kernels; the
attention kernels, each with a tensor-core and a CUDA-core body, also count
each body's launches (``body_counts``).

Gradients. The reference's Pallas kernels have no backward (no
``custom_vjp``), so the reference trains through XLA's autodiff of its
plain ``jnp`` attention. On the card, ``flash_attention`` with an input
that requires grad runs ``_FlashFn``: the forward launches the kernel, the
backward is the autodiff of the plain version (``ref.mha_reference``),
recomputed from the saved q, k, v; ``body_counts()`` counts those
backwards under ``"flash_attention/backward_plain"``. The other four
kernels serve only: on the card they raise on an input that requires grad,
so no gradient is ever lost in a launch. On the CPU, autograd flows
through the plain versions.

Modes, as the reference's (environment knobs read at import, or the
setters):

* ``REPRO_ATTN_MODE`` = ``masked_full`` | ``causal_skip``
  (``set_attention_mode``). On a CPU tensor, ``flash_attention`` over more
  than 2^20 (query, key) pairs takes the blocked plain version: the skip
  variant for a causal call under ``causal_skip``,
  ``ref.flash_attention_blocked`` otherwise. On a CUDA tensor the kernel
  launches in both modes (the reference's Pallas branch ignores the mode
  too). A ``meta`` tensor takes ``ref.mha_reference`` in both: the blocked
  walks give the same shapes, and their Python loops would cost a dry run
  minutes a 32k cell.
* ``REPRO_DECODE_MODE`` = ``scatter`` | ``append`` (``set_decode_mode``).
  ``append`` makes a slot-contiguous decode step attend the old cache
  with ``ref.decode_attention_with_stats`` and merge the new token in
  closed form, its K/V written once after the layers
  (``models/attention.py``, ``models/transformer.py::run_blocks``); paged
  caches ignore it. That attention is plain PyTorch on the card too, as
  it is plain ``jnp`` in the reference: no kernel replaces it. The
  reference's third value, ``paged``, picks its engines' layout; the
  port's engines take that as ``Engine(paged=...)``, so here it raises.

Sanitize mode (``REPRO_SANITIZE=1``, read at import, or
``set_sanitize_mode``) runs ``analysis/kernelcheck.py``'s contract checks
before every paged decode and ragged launch, on the CPU and on the card
alike; on the card their value checks read the index tensors on the host.
With the mode off dispatch is unchanged and reads no device data.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ragged_attention as _ra
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import wkv6 as _wkv

_COUNTS = (_ra.LAUNCHES, _da.LAUNCHES, _fa.LAUNCHES, _wkv.LAUNCHES)
# the plain backwards of flash calls that required grad on the card
BACKWARDS = {"flash_attention/backward_plain": 0}
_BODY_COUNTS = (_ra.BODY_LAUNCHES, _da.BODY_LAUNCHES,
                _fa.BODY_LAUNCHES, BACKWARDS)

_SANITIZE = os.environ.get("REPRO_SANITIZE", "0").lower() \
    not in ("", "0", "off", "false")

ATTN_MODES = ("masked_full", "causal_skip")
DECODE_MODES = ("scatter", "append")
# (query, key) pairs past which the CPU's flash takes the blocked version
BLOCKED_PAIRS = 1 << 20


def _mode(name: str, value: str, allowed) -> str:
    if value not in allowed:
        hint = (": the layout is Engine(paged=...) here"
                if value == "paged" else "")
        raise ValueError(f"{name}={value!r}: want {'|'.join(allowed)}"
                         f"{hint}")
    return value


_ATTN_MODE = _mode("REPRO_ATTN_MODE",
                   os.environ.get("REPRO_ATTN_MODE", "masked_full"),
                   ATTN_MODES)
_DECODE_MODE = _mode("REPRO_DECODE_MODE",
                     os.environ.get("REPRO_DECODE_MODE", "scatter"),
                     DECODE_MODES)


def set_attention_mode(mode: str):
    global _ATTN_MODE
    _ATTN_MODE = _mode("attention mode", mode, ATTN_MODES)


def attention_mode() -> str:
    return _ATTN_MODE


def set_decode_mode(mode: str):
    global _DECODE_MODE
    _DECODE_MODE = _mode("decode mode", mode, DECODE_MODES)


def decode_mode() -> str:
    return _DECODE_MODE


def set_sanitize_mode(on: bool):
    global _SANITIZE
    _SANITIZE = bool(on)


def sanitize_mode() -> bool:
    """Correctness tooling on (analysis/): the engines' KV-lifecycle
    sanitizer by default and the kernel contract checks at dispatch."""
    return _SANITIZE


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel for device {t.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``, by kernel."""
    return {k: n for counts in _COUNTS for k, n in counts.items()}


def body_counts() -> Dict[str, int]:
    """Launches since the last ``reset_launch_counts`` by kernel and body:
    ``"<kernel>/tensor_core"`` and ``"<kernel>/cuda_core"``; and
    ``"flash_attention/backward_plain"``, ``_FlashFn``'s backwards."""
    return {k: n for counts in _BODY_COUNTS for k, n in counts.items()}


def reset_launch_counts():
    for counts in (_COUNTS + _BODY_COUNTS
                   + (_fa.TILE_LAUNCHES, _ra.TILE_LAUNCHES)):
        for k in counts:
            counts[k] = 0


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _refuse_grad(name: str, *ts):
    """A serving kernel on the card takes no input that requires grad: it
    has no backward, nor has the reference's Pallas kernel."""
    if _wants_grad(*ts):
        raise ValueError(
            f"{name}: an input requires grad, and the kernel has no "
            f"backward (nor has the reference's Pallas kernel, which has no "
            f"custom_vjp): it serves only; train on the CPU's plain version")


def flash_backward_plain(q, k, v, dout, causal: bool, q_offset: int):
    """The gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v) for
    the output cotangent ``dout``: the autodiff of the plain version,
    recomputed from q, k, v."""
    BACKWARDS["flash_attention/backward_plain"] += 1
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = _ref.mha_reference(*qkv, causal=causal, q_offset=q_offset)
    return torch.autograd.grad(out, qkv, dout)


class _FlashFn(torch.autograd.Function):
    """The flash kernel forward, the plain version's autodiff backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_offset = causal, q_offset
        return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        grads = flash_backward_plain(q, k, v, dout, ctx.causal, ctx.q_offset)
        return tuple(g if need else None for g, need
                     in zip(grads, ctx.needs_input_grad)) + (None, None)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len=None):
    """Prefill attention over slot-contiguous K/V. q (B,Sq,Hq,hd); k, v
    (B,Sk,Hkv,hd). ``kv_len`` (B,) is the plain version's only: the
    kernel, like the Pallas one, takes none, and on the card it raises.
    On the card, a call with an input that requires grad goes through
    ``_FlashFn``; any other takes the kernel's launch alone, in either
    attention mode. On the CPU, past ``BLOCKED_PAIRS`` (query, key) pairs
    the plain version is the blocked one (the attention mode picks which);
    at or under it, and on ``meta``, it is ``ref.mha_reference``."""
    if _on_card(q):
        if kv_len is not None:
            raise ValueError("flash_attention: the kernel takes no kv_len "
                             "(as the Pallas kernel takes none)")
        if _wants_grad(q, k, v):
            return _FlashFn.apply(q, k, v, causal, q_offset)
        return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type == "meta" or q.shape[1] * k.shape[1] <= BLOCKED_PAIRS:
        return _ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_len=kv_len)
    if causal and _ATTN_MODE == "causal_skip":
        return _ref.flash_attention_blocked_skip(q, k, v, q_offset=q_offset,
                                                 kv_len=kv_len)
    return _ref.flash_attention_blocked(q, k, v, causal=causal,
                                        q_offset=q_offset, kv_len=kv_len)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-token decode against slot-contiguous caches. q (B,1,Hq,hd);
    caches (B,S,Hkv,hd); kv_len (B,) int32."""
    if _on_card(q):
        _refuse_grad("decode_attention", q, k_cache, v_cache)
        return _da.decode_attention(q, k_cache, v_cache, kv_len)
    return _ref.decode_attention_reference(q, k_cache, v_cache, kv_len)


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len):
    """Single-token decode against a paged KV pool. q (B,1,Hq,hd);
    pages (N,bs,Hkv,hd); block_tables (B,nb) page ids; kv_len (B,)."""
    if _SANITIZE:
        from repro_torch.analysis import kernelcheck
        kernelcheck.check_paged_decode(q, k_pages, v_pages, block_tables,
                                       kv_len)
    if _on_card(q):
        _refuse_grad("paged_decode_attention", q, k_pages, v_pages)
        return _da.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          kv_len)
    return _ref.paged_decode_attention_reference(
        q, k_pages, v_pages, block_tables, kv_len)


def ragged_paged_attention(q, k_pages, v_pages, tables, row, pos, *,
                           kv_quant=None):
    """Fused ragged-batch attention over a paged pool: one launch serves a
    whole mixed prefill-chunk + decode step. q (T,Hq,hd) flattened query
    tokens; pages (N,bs,Hkv,hd); tables (B,nb); row (T,) table row per
    token; pos (T,) absolute position per token (-1 = pad). T is a multiple
    of ``ragged_attention.TILE_Q`` and row is constant over each tile. ``kv_quant``
    carries int8 pools' scale/zero leaves (dequant fused into the K/V
    loads)."""
    if _SANITIZE:
        from repro_torch.analysis import kernelcheck
        kernelcheck.check_ragged_paged(q, k_pages, v_pages, tables, row,
                                       pos, kv_quant=kv_quant,
                                       tile_q=_ra.TILE_Q)
    if _on_card(q):
        _refuse_grad("ragged_paged_attention", q, k_pages, v_pages,
                     *(kv_quant or {}).values())
        return _ra.ragged_paged_attention(q, k_pages, v_pages, tables, row,
                                          pos, kv_quant=kv_quant)
    return _ref.ragged_paged_attention_reference(
        q, k_pages, v_pages, tables, row, pos, kv_quant=kv_quant)


def wkv6(r, k, v, w, u, initial_state=None, *, chunk: int = 64,
         out_state=None):
    """RWKV6 recurrence. r, k, v, w (B,T,H,hd); u (H,hd) float32;
    initial_state (B,H,hd,hd) float32 or None. Returns (y in r's dtype,
    final state float32); with ``out_state`` the final state is written
    there (it may be ``initial_state``: the recurrence's state updated in
    place). ``chunk`` is the plain version's time chunk; the kernel needs
    none."""
    if _on_card(r):
        _refuse_grad("wkv6", r, k, v, w, u, initial_state)
        return _wkv.wkv6(r, k, v, w, u, initial_state, out_state=out_state)
    y, s = _ref.wkv6_chunked(r, k, v, w, u, initial_state, chunk=chunk)
    if out_state is not None:
        out_state.copy_(s)
        s = out_state
    return y, s
