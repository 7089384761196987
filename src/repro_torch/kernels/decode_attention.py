"""Decode attention: the wrappers of the two CUDA decode kernels.

One query token per sequence, masked by ``kv_len``, either

* against the shared page pool through block tables: ``csrc/
  paged_decode_attention.cu`` (replaces ``src/repro/kernels/
  decode_attention.py::paged_decode_attention``; plain version
  ``kernels/ref.py::paged_decode_attention_reference``), or
* against slot-contiguous caches (B, S, Hkv, hd): ``csrc/
  decode_attention.cu`` (replaces ``decode_attention.py::decode_attention``;
  plain version ``kernels/ref.py::decode_attention_reference``).

Two bodies each, chosen by dtype in the C entry points: a bf16 q over bf16
pages, and bf16 or fp16 caches, run on the tensor cores with the key walk
split over blocks of ``SPLIT_KEYS`` positions and a combine pass
(``csrc/decode_split.cuh``); float32, and fp16 pages under a bf16 q, run on
the CUDA cores (f32 FMAs), so the f32 checks hold them to 1e-5.
``BODY_LAUNCHES`` counts each body's launches apart. The split's f32
workspace is sized from shapes alone (``split_count``): the wrappers never
read ``kv_len`` on the host, so a call holds no sync.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import softmax_scale

HEAD_DIMS = (16, 32, 64, 128)
Q_DTYPES = (torch.float32, torch.bfloat16)
PAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# kv positions a split of the tensor-core bodies: csrc/decode_split.cuh's
# KPS, which the C entry points hold the workspace's split count to
SPLIT_KEYS = 128

# launches, counted where each kernel is launched; and by body
LAUNCHES = {"paged_decode_attention": 0, "decode_attention": 0}
BODY_LAUNCHES = {f"{name}/{body}": 0 for name in LAUNCHES
                 for body in ("tensor_core", "cuda_core")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _I, _P,
                                    ctypes.POINTER(_I)])
_CONTIG_ARGTYPES = ([_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _P,
                                           ctypes.POINTER(_I)])


def split_count(n_keys: int) -> int:
    """Splits of the tensor-core bodies over ``n_keys`` kv positions (a
    table's nb * bs, or a cache's S): a function of shapes only."""
    return -(-n_keys // SPLIT_KEYS)


def _workspace(q, n_split):
    """The split's f32 partials: o (B, Hq, n_split, hd), then m and l
    (B, Hq, n_split) each."""
    b, _, hq, hd = q.shape
    return torch.empty(b * hq * n_split * (hd + 2), dtype=torch.float32,
                       device=q.device)


def _count(name, body):
    LAUNCHES[name] += 1
    BODY_LAUNCHES[f"{name}/{_build.BODIES[body.value]}"] += 1


def check_paged_operands(q, k_pages, v_pages, block_tables, kv_len):
    """Raises ``ValueError`` on an operand the paged kernel does not take:
    its dtypes, head dims, shapes, int32 indices, and starts on 16 bytes.
    Reads shapes and pointers only, never device data;
    ``analysis/kernelcheck.py`` applies the same rules."""
    b, one, hq, hd = q.shape
    hkv, hd_k = k_pages.shape[2:]
    if one != 1:
        raise ValueError(f"one query token per sequence, got {one}")
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype}: the kernel takes {Q_DTYPES}")
    if k_pages.dtype not in PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"page dtypes {k_pages.dtype}/{v_pages.dtype}: "
                         f"the kernel takes {PAGE_DTYPES}")
    if hd not in HEAD_DIMS or hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"head_dim {hd} (pages {tuple(k_pages.shape)}): "
                         f"the kernel takes head dims {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    for k, a in (("block_tables", block_tables), ("kv_len", kv_len)):
        if a.dtype != torch.int32:
            raise ValueError(f"{k} must be int32, got {a.dtype}")
    if block_tables.shape[0] != b or kv_len.shape != (b,):
        raise ValueError("block_tables must be (B, nb), kv_len (B,)")
    _build.check_aligned("paged_decode_attention", k_pages=k_pages,
                         v_pages=v_pages)


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len):
    """q (B,1,Hq,hd); pages (N,bs,Hkv,hd); block_tables (B,nb) int32 page
    ids; kv_len (B,) int32 -> (B,1,Hq,hd) in q's dtype. Launches the CUDA
    kernel on the current stream; raises on anything it does not take."""
    _build.check_cuda("paged_decode_attention", q=q, k_pages=k_pages,
                      v_pages=v_pages, block_tables=block_tables,
                      kv_len=kv_len)
    check_paged_operands(q, k_pages, v_pages, block_tables, kv_len)
    b, _, hq, hd = q.shape
    bs, hkv = k_pages.shape[1:3]
    nb = block_tables.shape[1]
    out = torch.empty_like(q)
    n_split = split_count(nb * bs)
    ws = _workspace(q, n_split)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("paged_decode_attention", _ARGTYPES)
    body = ctypes.c_int(-1)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
             ws.data_ptr(), b, hq, hkv, hd, nb, bs, n_split,
             softmax_scale(hd), _build.dtype_code(q.dtype),
             _build.dtype_code(k_pages.dtype), stream, ctypes.byref(body))
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    _count("paged_decode_attention", body)
    return out


def decode_attention(q, k_cache, v_cache, kv_len):
    """q (B,1,Hq,hd); caches (B,S,Hkv,hd) in q's dtype; kv_len (B,) int32
    -> (B,1,Hq,hd). Row b attends its cache rows [0, kv_len[b]) (clamped
    to [0, S]); the kernel reads no row past that. Launches the CUDA kernel
    on the current stream; raises on anything it does not take."""
    _build.check_cuda("decode_attention", q=q, k_cache=k_cache,
                      v_cache=v_cache, kv_len=kv_len)
    b, one, hq, hd = q.shape
    bk, s, hkv, hd_k = k_cache.shape
    if one != 1:
        raise ValueError(f"one query token per sequence, got {one}")
    if (q.dtype not in CACHE_DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"decode_attention: q/cache dtypes {q.dtype}/"
                         f"{k_cache.dtype}/{v_cache.dtype}: want one of "
                         f"{CACHE_DTYPES} for all three")
    if (hd not in HEAD_DIMS or hd_k != hd or v_cache.shape != k_cache.shape
            or bk != b):
        raise ValueError(f"head_dim {hd} (q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}): want one of {HEAD_DIMS} "
                         f"and matching shapes")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (b,):
        raise ValueError(f"kv_len must be int32 (B,), got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)}")
    _build.check_aligned("decode_attention", k_cache=k_cache,
                         v_cache=v_cache)
    out = torch.empty_like(q)
    n_split = split_count(s)
    ws = _workspace(q, n_split)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("decode_attention", _CONTIG_ARGTYPES)
    body = ctypes.c_int(-1)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(), b, s, hq, hkv,
             hd, n_split, softmax_scale(hd), _build.dtype_code(q.dtype),
             stream, ctypes.byref(body))
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    _count("decode_attention", body)
    return out
