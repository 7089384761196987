"""Kernel dispatch layer: by the device of the tensors.

Models call these wrappers. A CPU tensor takes the kernel's plain PyTorch
version (``kernels/ref.py``); a CUDA tensor takes the hand-written CUDA
kernel, which launches or raises. There is no switch that runs the plain
version on the card.

Each kernel counts its launches (``launch_counts``), so a run can show
that its attention and its recurrences went through the kernels; the
attention kernels, each with a tensor-core and a CUDA-core body, also count
each body's launches (``body_counts``).

Sanitize mode (``REPRO_SANITIZE=1``, read at import, or
``set_sanitize_mode``) runs ``analysis/kernelcheck.py``'s contract checks
before every paged decode and ragged launch, on the CPU and on the card
alike; on the card their value checks read the index tensors on the host.
With the mode off dispatch is unchanged and reads no device data.
"""

from __future__ import annotations

import os
from typing import Dict

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ragged_attention as _ra
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import wkv6 as _wkv

_COUNTS = (_ra.LAUNCHES, _da.LAUNCHES, _fa.LAUNCHES, _wkv.LAUNCHES)
_BODY_COUNTS = (_ra.BODY_LAUNCHES, _da.BODY_LAUNCHES,
                _fa.BODY_LAUNCHES)

_SANITIZE = os.environ.get("REPRO_SANITIZE", "0").lower() \
    not in ("", "0", "off", "false")


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
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``, by kernel."""
    return {k: n for counts in _COUNTS for k, n in counts.items()}


def body_counts() -> Dict[str, int]:
    """Launches since the last ``reset_launch_counts`` by kernel and body:
    ``"<kernel>/tensor_core"`` and ``"<kernel>/cuda_core"``."""
    return {k: n for counts in _BODY_COUNTS for k, n in counts.items()}


def reset_launch_counts():
    for counts in _COUNTS + _BODY_COUNTS:
        for k in counts:
            counts[k] = 0


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len=None):
    """Prefill attention over slot-contiguous K/V. q (B,Sq,Hq,hd); k, v
    (B,Sk,Hkv,hd). ``kv_len`` (B,) is the plain version's only: the
    kernel, like the Pallas one, takes none, and on the card it raises."""
    if _on_card(q):
        if kv_len is not None:
            raise ValueError("flash_attention: the kernel takes no kv_len "
                             "(as the Pallas kernel takes none)")
        return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return _ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-token decode against slot-contiguous caches. q (B,1,Hq,hd);
    caches (B,S,Hkv,hd); kv_len (B,) int32."""
    if _on_card(q):
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
        return _wkv.wkv6(r, k, v, w, u, initial_state, out_state=out_state)
    y, s = _ref.wkv6_chunked(r, k, v, w, u, initial_state, chunk=chunk)
    if out_state is not None:
        out_state.copy_(s)
        s = out_state
    return y, s
