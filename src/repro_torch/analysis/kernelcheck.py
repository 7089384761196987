"""Pre-launch checks of the Hopper attention kernels' contracts.

Validates the calling conventions of ``kernels/ragged_attention.py`` and
``kernels/decode_attention.py`` before a launch: rank and shape
consistency between q, the page pools and the index tensors, GQA
grouping, int8 quant-leaf shapes, the pad-row convention (``pos = -1``
tokens are masked and come back 0, so ``pos`` must be a *signed* integer
type), and the values of the index tensors: page ids inside the pool, rows
inside the batch, ``pos >= -1``, ``row`` constant over each ``TILE_Q``
tile, ``kv_len`` within the table's capacity.

The port of ``src/repro/analysis/kernelcheck.py``. Its TPU tiling rules
(8 sublanes, 128 lanes) are replaced by what the CUDA kernels demand, by
calling the wrappers' own operand checks (``ragged_attention.
check_operands``, ``decode_attention.check_paged_operands``): each
wrapper's ``HEAD_DIMS`` and its q and page dtype sets, int32 index
tensors, and page pools that start on 16 bytes (the kernels gather pages
with ``cp.async``). Those rules are errors for a launch on the card
(``backend="cuda"``) and warnings on the CPU (``backend="cpu"``), whose
plain versions take any head dim, dtype or alignment; ``backend=None``
takes the device of ``q``.

Called from ``kernels/ops.py`` dispatch when sanitize mode is on
(``REPRO_SANITIZE=1`` / ``ops.set_sanitize_mode(True)``), on every launch.
**Cost on the card:** the value checks read ``tables``, ``row``, ``pos``
and ``kv_len`` on the host, which is a device-to-host copy and a
synchronisation at each launch. That is acceptable in sanitize mode only;
with the mode off dispatch never calls this module, and no wrapper reads
device data on the host.

Violations raise :class:`KernelContractError`.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ragged_attention as _ra
from repro_torch.models.attention import KV_QUANT_LEAVES

__all__ = ["KernelContractError", "check_ragged_paged",
           "check_paged_decode"]


class KernelContractError(ValueError):
    """A kernel operand violates the launch contract."""


def _shape(x):
    return tuple(x.shape)


def _err(msg: str):
    raise KernelContractError(msg)


def _backend(q, backend: Optional[str]) -> str:
    if backend is None:
        return "cuda" if q.is_cuda else "cpu"
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"backend {backend!r}: want 'cuda' or 'cpu'")
    return backend


def _hopper(check, backend: str, *args):
    """The wrapper's own operand check ``check(*args)``: what it refuses is
    an error for a launch on the card, a warning on the CPU, whose plain
    version takes the operand as it is."""
    try:
        check(*args)
    except ValueError as e:
        if backend == "cuda":
            _err(str(e))
        warnings.warn(f"kernelcheck: {e} (backend='cpu': tolerated by the "
                      f"plain version)", stacklevel=3)


def _is_int(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _check_pages(k_pages, v_pages):
    if k_pages.dim() != 4:
        _err(f"k_pages must be (n_pages, page_size, n_kv_heads, head_dim), "
             f"got {_shape(k_pages)}")
    if _shape(k_pages) != _shape(v_pages):
        _err(f"k_pages {_shape(k_pages)} != v_pages {_shape(v_pages)}")
    if k_pages.dtype != v_pages.dtype:
        _err(f"k_pages dtype {k_pages.dtype} != v_pages dtype "
             f"{v_pages.dtype}")
    if k_pages.shape[0] < 2:
        _err(f"n_pages = {k_pages.shape[0]}: the pool must hold at least "
             f"one real page plus the trailing null/trash page "
             f"(n_blocks + 1)")


def _check_quant(kv_quant, k_pages):
    if kv_quant is None:
        return
    missing = [l for l in KV_QUANT_LEAVES if l not in kv_quant]
    if missing:
        _err(f"kv_quant missing leaves {missing}: int8 pools carry "
             f"{KV_QUANT_LEAVES}")
    want = _shape(k_pages)[:-1]
    for leaf in KV_QUANT_LEAVES:
        a = kv_quant[leaf]
        if _shape(a) != want:
            _err(f"kv_quant[{leaf!r}] shape {_shape(a)} != k_pages[:-1] "
                 f"{want}")
        if a.dtype != torch.float32:
            _err(f"kv_quant[{leaf!r}] dtype {a.dtype}: scale/zero leaves "
                 f"are float32")


def _check_gqa(q, k_pages):
    hq, hd = q.shape[-2], q.shape[-1]
    hkv, hd_kv = k_pages.shape[2], k_pages.shape[3]
    if hd_kv != hd:
        _err(f"q head_dim {hd} != page head_dim {hd_kv}")
    if hq % hkv != 0:
        _err(f"n_q_heads {hq} not a multiple of n_kv_heads {hkv} (GQA "
             f"grouping)")


def _host(a) -> torch.Tensor:
    """The values on the host: a device-to-host copy and a sync on the
    card (sanitize mode only)."""
    return a.detach().to("cpu", torch.int64)


def check_ragged_paged(q, k_pages, v_pages, tables, row, pos, *,
                       kv_quant=None, tile_q: int = _ra.TILE_Q,
                       backend: Optional[str] = None):
    """Contract of ``ragged_attention.ragged_paged_attention``: q (T, Hq,
    hd) flattened tokens, T a multiple of ``tile_q``; ``row``/``pos`` (T,)
    the per-token descriptors (row constant per tile, pos = -1 marks
    pads); ``tables`` (B, nb) page ids."""
    if q.dim() != 3:
        _err(f"q must be (T, n_q_heads, head_dim), got {_shape(q)}")
    backend = _backend(q, backend)
    t = q.shape[0]
    _check_pages(k_pages, v_pages)
    _check_gqa(q, k_pages)
    if t % tile_q != 0:
        _err(f"T = {t} tokens not a multiple of tile_q = {tile_q}: the "
             f"caller pads each segment's span to tile alignment")
    if tables.dim() != 2:
        _err(f"tables must be (B, nb), got {_shape(tables)}")
    for name, a in (("row", row), ("pos", pos)):
        if a.dim() != 1 or a.shape[0] != t:
            _err(f"{name} must be ({t},) to match the flattened token "
                 f"axis, got {_shape(a)}")
        if not _is_int(a.dtype):
            _err(f"{name} dtype {a.dtype}: the per-token descriptors are "
                 f"integer")
    if not pos.dtype.is_signed:
        _err(f"pos dtype {pos.dtype} cannot carry the pad marker -1 "
             f"(pad rows -> zeros convention needs a signed type)")
    _check_quant(kv_quant, k_pages)
    _hopper(_ra.check_operands, backend, q, k_pages, v_pages, tables, row,
            pos, kv_quant)
    n_pages = k_pages.shape[0]
    tb, rw, ps = _host(tables), _host(row), _host(pos)
    if tb.numel() and (tb.min() < 0 or tb.max() >= n_pages):
        _err(f"tables reference page ids outside [0, {n_pages}): range "
             f"[{int(tb.min())}, {int(tb.max())}]")
    if t and (rw.min() < 0 or rw.max() >= tables.shape[0]):
        _err(f"row references table rows outside [0, {tables.shape[0]}): "
             f"range [{int(rw.min())}, {int(rw.max())}]")
    if t and ps.min() < -1:
        _err(f"pos carries values below the pad marker -1 "
             f"(min {int(ps.min())})")
    # row must be constant within each tile_q tile (one table row per
    # query tile: the kernel reads the tile's row from its first token)
    tiles = rw.reshape(-1, tile_q)
    bad = (tiles != tiles[:, :1]).any(dim=1)
    if bool(bad.any()):
        _err(f"row changes inside query tile {int(bad.nonzero()[0, 0])}: "
             f"segments must be padded so each tile_q span stays on one "
             f"table row")


def check_paged_decode(q, k_pages, v_pages, block_tables, kv_len, *,
                       backend: Optional[str] = None):
    """Contract of ``decode_attention.paged_decode_attention``: q (B, 1,
    Hq, hd) one token per sequence; ``block_tables`` (B, nb) page ids;
    ``kv_len`` (B,) valid rows per sequence."""
    if q.dim() != 4 or q.shape[1] != 1:
        _err(f"q must be (B, 1, n_q_heads, head_dim), got {_shape(q)}")
    backend = _backend(q, backend)
    b = q.shape[0]
    _check_pages(k_pages, v_pages)
    _check_gqa(q, k_pages)
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        _err(f"block_tables must be ({b}, nb), got {_shape(block_tables)}")
    if kv_len.dim() != 1 or kv_len.shape[0] != b:
        _err(f"kv_len must be ({b},), got {_shape(kv_len)}")
    if not _is_int(block_tables.dtype):
        _err(f"block_tables dtype {block_tables.dtype}: page ids are "
             f"integer")
    _hopper(_da.check_paged_operands, backend, q, k_pages, v_pages,
            block_tables, kv_len)
    n_pages, page_size = k_pages.shape[0], k_pages.shape[1]
    tb, kl = _host(block_tables), _host(kv_len)
    if tb.numel() and (tb.min() < 0 or tb.max() >= n_pages):
        _err(f"block_tables reference page ids outside [0, {n_pages}): "
             f"range [{int(tb.min())}, {int(tb.max())}]")
    cap = block_tables.shape[1] * page_size
    if b and (kl.min() < 0 or kl.max() > cap):
        _err(f"kv_len range [{int(kl.min())}, {int(kl.max())}] exceeds the "
             f"table capacity {block_tables.shape[1]} blocks x "
             f"{page_size} rows")
