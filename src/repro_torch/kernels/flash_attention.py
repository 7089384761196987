"""Flash attention over slot-contiguous K/V: the CUDA kernel's wrapper.

GQA attention of a prompt's queries over its keys, causal or not, with a
static ``q_offset``; key padding is the kernel's own ragged edge.
Kernel: ``csrc/flash_attention.cu`` (replaces
``src/repro/kernels/flash_attention.py::flash_attention``); plain version:
``kernels/ref.py::mha_reference``.

Two bodies, chosen by dtype and GQA group G in the C entry point: bf16 and
fp16 with G <= 64 run on the tensor cores (``wgmma``, K/V stages by TMA
into an mbarrier ring fed by a producer warp; a tile of positions times G
is 128 query rows, two consumer warpgroups, or 64 where that grid would
leave SMs idle); float32 and larger groups run on the CUDA cores (32 rows
a block, f32 FMAs), so the f32 checks hold it to 1e-5.
``BODY_LAUNCHES`` counts each body's launches apart, and ``TILE_LAUNCHES``
the tensor-core body's by the tile the entry point reports it launched.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import softmax_scale

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# launches, counted where the kernel is launched; and by body
LAUNCHES = {"flash_attention": 0}
BODY_LAUNCHES = {"flash_attention/tensor_core": 0,
                 "flash_attention/cuda_core": 0}
# the tensor-core body's launches by its tile's query rows
TILE_LAUNCHES = {64: 0, 128: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 4 + [_I] * 8 + [ctypes.c_float, _I, _P]
             + [ctypes.POINTER(_I)] * 2)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B,Sq,Hq,hd); k, v (B,Sk,Hkv,hd), all one dtype -> (B,Sq,Hq,hd) in
    q's dtype. Launches the CUDA kernel on the current stream; raises on
    anything it does not take."""
    _build.check_cuda("flash_attention", q=q, k=k, v=v)
    b, sq, hq, hd = q.shape
    bk, sk, hkv, hd_k = k.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}: want one of {DTYPES} for all three")
    if hd not in HEAD_DIMS or hd_k != hd or v.shape != k.shape or bk != b:
        raise ValueError(f"head_dim {hd} (q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}): want one "
                         f"of {HEAD_DIMS} and matching shapes")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if sk < 1 or q_offset < 0:
        raise ValueError(f"Sk={sk} must be >= 1 and q_offset={q_offset} >= 0")
    _build.check_aligned("flash_attention", k=k, v=v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = _build.entry("flash_attention", _ARGTYPES)
    body, tile = ctypes.c_int(-1), ctypes.c_int(-1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             sk, hq, hkv, hd, int(bool(causal)), int(q_offset),
             softmax_scale(hd), _build.dtype_code(q.dtype), stream,
             ctypes.byref(body), ctypes.byref(tile))
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    BODY_LAUNCHES[f"flash_attention/{_build.BODIES[body.value]}"] += 1
    if tile.value:
        TILE_LAUNCHES[tile.value] += 1
    return out

