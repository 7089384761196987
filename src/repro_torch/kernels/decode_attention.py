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
pages, and bf16 or fp16 caches, run on the tensor cores in one launch
(``csrc/decode_split.cuh``): the key walk split over blocks of
``SPLIT_KEYS`` positions, the blocks of one (sequence, kv head) a thread
block cluster of at most ``cluster_size`` blocks that combines the splits
before the launch ends, K and V brought by TMA; float32, and fp16 pages
under a bf16 q, run on the CUDA cores (f32 FMAs), so the f32 checks hold
them to 1e-5. ``BODY_LAUNCHES`` counts each body's launches apart, and
``LAST_LAUNCH`` records each kernel's last tensor-core launch: the
cluster size it took (the C entry point may take fewer blocks, so that
the grid fits the card at once) and where its partials went (the f32
workspace, whose size follows from shapes alone: ``split_count``). The
wrappers never read ``kv_len`` on the host, so a call holds no sync.
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
# the most blocks a cluster: the portable cluster size (the C entry points
# refuse more than 16, and the card any cluster it cannot hold)
CLUSTER_MAX = 8

# launches, counted where each kernel is launched; and by body
LAUNCHES = {"paged_decode_attention": 0, "decode_attention": 0}
BODY_LAUNCHES = {f"{name}/{body}": 0 for name in LAUNCHES
                 for body in ("tensor_core", "cuda_core")}
# each kernel's last tensor-core launch: {"cluster": C, "partials":
# "workspace"}
LAST_LAUNCH = {name: None for name in LAUNCHES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_OUT = ctypes.POINTER(_I)
_ARGTYPES = ([_P] * 7 + [_I] * 7 + [ctypes.c_float] + [_I] * 4
             + [_P, _OUT, _OUT])
_CONTIG_ARGTYPES = ([_P] * 6 + [_I] * 6 + [ctypes.c_float] + [_I] * 2
                    + [_P, _OUT, _OUT])


def split_count(n_keys: int) -> int:
    """Splits of the tensor-core bodies over ``n_keys`` kv positions (a
    table's nb * bs, or a cache's S): a function of shapes only."""
    return -(-n_keys // SPLIT_KEYS)


def cluster_size(n_split: int) -> int:
    """The most blocks a (sequence, kv head) of the tensor-core launch: one
    a split, at most ``CLUSTER_MAX``, at least one. A function of shapes
    only; the C entry point takes this many, or the largest power of two
    below it whose grid the card holds at once."""
    return max(1, min(CLUSTER_MAX, n_split))


def _workspace(q, n_split):
    """The split's f32 partials: o (B, Hq, n_split, hd), then m and l
    (B, Hq, n_split) each."""
    b, _, hq, hd = q.shape
    return torch.empty(b * hq * n_split * (hd + 2), dtype=torch.float32,
                       device=q.device)


def _count(name, body, cluster):
    LAUNCHES[name] += 1
    BODY_LAUNCHES[f"{name}/{_build.BODIES[body.value]}"] += 1
    if cluster.value:
        LAST_LAUNCH[name] = {"cluster": cluster.value,
                             "partials": "workspace"}


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
    body, cluster = ctypes.c_int(-1), ctypes.c_int(0)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
             ws.data_ptr(), b, hq, hkv, hd, nb, bs, n_split,
             softmax_scale(hd), _build.dtype_code(q.dtype),
             _build.dtype_code(k_pages.dtype), k_pages.shape[0],
             cluster_size(n_split), stream, ctypes.byref(cluster),
             ctypes.byref(body))
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    _count("paged_decode_attention", body, cluster)
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
    body, cluster = ctypes.c_int(-1), ctypes.c_int(0)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(), b, s, hq, hkv,
             hd, n_split, softmax_scale(hd), _build.dtype_code(q.dtype),
             cluster_size(n_split), stream, ctypes.byref(cluster),
             ctypes.byref(body))
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    _count("decode_attention", body, cluster)
    return out
