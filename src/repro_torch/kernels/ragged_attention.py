"""Fused ragged-batch paged attention: the CUDA kernel's wrapper.

One launch serves a whole mixed serving step (prefill chunks of any length
and history, plus decode rows) flattened into ``q (T, Hq, hd)`` with a
block-table ``row`` and an absolute ``pos`` per token; pad tokens carry
``pos = -1`` and come back exactly 0. Kernel: ``csrc/ragged_paged_attention.cu``
(replaces ``src/repro/kernels/ragged_attention.py::ragged_paged_attention``);
plain version: ``kernels/ref.py::ragged_paged_attention_reference``.

Layout contract (the runner's): ``T`` is a multiple of ``TILE_Q`` and
``row`` is constant over each tile. ``TILE_Q`` is defined here only; the
runner and ``Model.prefill`` lay their ragged batches out by it. ``kv_quant`` (int8 pages' scale/zero
pools) selects the int8 body.

Two bodies, chosen by dtype in the C entry point. A bf16 q over bf16 or
int8 pages (GQA group G <= 8, pages of a power of two >= 4 rows) runs on
the tensor cores, three kernels launched side by side (programmatic
dependent launches): the decode runs (a run of tiles with one row holding
one real token) split over keys of ``SPLIT_KEYS`` positions and combined
as paged decode does, the rest in spans of tiles on ``wgmma`` with K/V
pages by TMA (64 or 128 query rows a block, reported by the launch);
which run takes which part is decided on the device. float32 q or pages,
fp16 pages, and G > 8 run on the CUDA cores (f32 FMAs), so the f32 checks
hold them to 1e-5. ``BODY_LAUNCHES`` counts each body's launches apart and
``TILE_LAUNCHES`` the tensor-core body's by its spans' rows. The split's
f32 workspace is sized from shapes alone (``workspace_splits``): the wrapper
reads no device data, so a launch can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import split_count
from repro_torch.kernels.ref import softmax_scale

TILE_Q = 8      # query tokens per block; every span is aligned to it
HEAD_DIMS = (16, 32, 64, 128)
Q_DTYPES = (torch.float32, torch.bfloat16)
PAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8)

# launches of the float-page and int8-page functions, counted where the
# kernel is launched; and of each, by the body that ran
LAUNCHES = {"ragged_paged_attention": 0, "ragged_paged_attention_q8": 0}
BODY_LAUNCHES = {f"{name}/{body}": 0 for name in LAUNCHES
                 for body in ("tensor_core", "cuda_core")}
# the tensor-core body's launches by its span kernel's query rows a block
TILE_LAUNCHES = {64: 0, 128: 0}
# the largest split workspace a launch takes; past it the spans walk the
# decode runs too (no split)
SPLIT_WORKSPACE_BYTES = 64 << 20
TC_GROUP = 8    # the tensor-core body's largest GQA group

_P = ctypes.c_void_p
_I = ctypes.c_int
_QUANT_LEAVES = ("k_scale", "k_zero", "v_scale", "v_zero")   # C order
_ARGTYPES = ([_P] * 12 + [_I] * 9 + [ctypes.c_float, _I, _I, _P]
             + [ctypes.POINTER(_I)] * 2)


def check_page_size(bs, q_dtype, page_dtype, group):
    """Raises ``ValueError`` on a page size that the kernel's tensor-core
    body would get and does not take: a bf16 q over bf16 or int8 pages
    with a GQA group of at most ``TC_GROUP`` needs pages of a power of two
    >= 4 rows (a stage of its spans is whole pages, each box on 128
    bytes). The other bodies take any size. ``check_operands`` and, on a
    CUDA device, ``Engine`` apply it."""
    if (q_dtype == torch.bfloat16
            and page_dtype in (torch.bfloat16, torch.int8)
            and group <= TC_GROUP and (bs < 4 or bs & (bs - 1))):
        raise ValueError(f"page size {bs}: the tensor-core body takes pages "
                         f"of a power of two >= 4 rows")


def check_operands(q, k_pages, v_pages, tables, row, pos, kv_quant=None):
    """Raises ``ValueError`` on an operand the kernel does not take: its
    dtypes, head dims, shapes, int32 indices, the int8 pages' scale/zero
    pools, and starts on 16 bytes. Reads shapes and pointers only, never
    device data; ``analysis/kernelcheck.py`` applies the same rules."""
    t, hq, hd = q.shape
    hkv, hd_k = k_pages.shape[2:]
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype}: the kernel takes {Q_DTYPES}")
    if k_pages.dtype not in PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"page dtypes {k_pages.dtype}/{v_pages.dtype}: "
                         f"the kernel takes {PAGE_DTYPES}")
    if hd not in HEAD_DIMS or hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"head_dim {hd} (pages {tuple(k_pages.shape)}): "
                         f"the kernel takes head dims {HEAD_DIMS}")
    if hq % hkv or t % TILE_Q:
        raise ValueError(f"Hq={hq} Hkv={hkv} T={t} TILE_Q={TILE_Q}")
    for k, a in (("tables", tables), ("row", row), ("pos", pos)):
        if a.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {a.dtype}")
    if row.shape != (t,) or pos.shape != (t,) or tables.dim() != 2:
        raise ValueError("row/pos must be (T,), tables (B, nb)")
    if (k_pages.dtype == torch.int8) != (kv_quant is not None):
        raise ValueError("int8 pages need kv_quant scale/zero pools, and "
                         "only int8 pages take them")
    for k in _QUANT_LEAVES if kv_quant is not None else ():
        a = kv_quant[k]
        if a.dtype != torch.float32 or a.shape != k_pages.shape[:-1]:
            raise ValueError(f"{k}: want f32 {tuple(k_pages.shape[:-1])}")
    check_page_size(k_pages.shape[1], q.dtype, k_pages.dtype, hq // hkv)
    _build.check_aligned("ragged_paged_attention", k_pages=k_pages,
                         v_pages=v_pages)


def ragged_paged_attention(q, k_pages, v_pages, tables, row, pos, *,
                           kv_quant=None):
    """q (T,Hq,hd) ragged query tokens; pages (N,bs,Hkv,hd); tables (B,nb)
    int32 page ids; row (T,) int32 table row per token; pos (T,) int32
    absolute position per token (-1 = pad) -> (T,Hq,hd) in q's dtype.
    Launches the CUDA kernel on the current stream; raises on anything it
    does not take."""
    quant = kv_quant or {}
    _build.check_cuda("ragged_paged_attention", q=q, k_pages=k_pages,
                      v_pages=v_pages, tables=tables, row=row, pos=pos,
                      **{k: quant.get(k) for k in _QUANT_LEAVES})
    check_operands(q, k_pages, v_pages, tables, row, pos, kv_quant)
    t, hq, hd = q.shape
    bs, hkv = k_pages.shape[1:3]
    nb = tables.shape[1]
    is_q8 = kv_quant is not None
    ptrs = [quant[k].data_ptr() if is_q8 else None for k in _QUANT_LEAVES]
    out = torch.empty_like(q)
    n_split = workspace_splits(t, hq, hd, nb * bs)
    ws = torch.empty(_workspace_floats(t, hq, hd, n_split),
                     dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("ragged_paged_attention", _ARGTYPES)
    body, tile = ctypes.c_int(-1), ctypes.c_int(-1)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *ptrs,
             tables.data_ptr(), row.data_ptr(), pos.data_ptr(),
             out.data_ptr(), ws.data_ptr() if n_split else None, t, hq, hkv,
             hd, nb, bs, k_pages.shape[0], TILE_Q, n_split,
             softmax_scale(hd), _build.dtype_code(q.dtype),
             _build.dtype_code(k_pages.dtype), stream, ctypes.byref(body),
             ctypes.byref(tile))
    if err:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    name = "ragged_paged_attention_q8" if is_q8 else "ragged_paged_attention"
    LAUNCHES[name] += 1
    BODY_LAUNCHES[f"{name}/{_build.BODIES[body.value]}"] += 1
    if tile.value:
        TILE_LAUNCHES[tile.value] += 1
    return out


def _workspace_floats(t, hq, hd, n_split):
    """The split's f32 workspace: o (T / TILE_Q, Hq, n_split, hd), then m
    and l (T / TILE_Q, Hq, n_split) each, then each tile's decode slot and
    key count (two int32 a tile); nothing without a split."""
    tiles = t // TILE_Q
    return tiles * (hq * n_split * (hd + 2) + 2) if n_split else 0


def workspace_splits(t, hq, hd, n_keys):
    """The split count of the decode runs' workspace, T / TILE_Q slots of
    Hq rows: ``split_count(n_keys)`` (the table's nb * bs), or 0 (no split)
    where the workspace would pass ``SPLIT_WORKSPACE_BYTES``. A function of
    shapes only."""
    n_split = split_count(n_keys)
    size = _workspace_floats(t, hq, hd, n_split) * 4
    return n_split if size <= SPLIT_WORKSPACE_BYTES else 0
