"""WKV6: the wrapper of the CUDA kernel of RWKV6's recurrence.

``csrc/wkv6.cu`` replaces ``src/repro/kernels/wkv6.py::wkv6``; its plain
version is ``kernels/ref.py::wkv6_chunked`` (``wkv6_reference`` per chunk).
One block per (batch row, head, group of ``COLUMNS_PER_BLOCK`` value
columns) walks the time axis with its columns of the float32 state in
registers, each column's key rows split over ``row_lanes(T)`` lanes whose
partial outputs are added in one fixed shuffle order; the rows of
``STEPS_PER_TILE`` steps are staged a tile ahead with ``cp.async``. A block
reads its columns of the initial state once and writes them once, so the
final state may overwrite the initial one in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
RKV_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# CT, JC, IG and IG_SHORT of csrc/wkv6.cu: steps a staged tile, value
# columns a block (at most hd), and the lanes that split one column's key
# rows in a launch of at least one whole tile and in a shorter one
STEPS_PER_TILE = 16
COLUMNS_PER_BLOCK = 16
ROW_LANES = 16
SHORT_ROW_LANES = 8


def row_lanes(t: int) -> int:
    """The lanes over which the kernel sums y in a launch of ``t`` steps:
    the order of that sum (a shuffle tree over them) depends on this
    alone."""
    return ROW_LANES if t >= STEPS_PER_TILE else SHORT_ROW_LANES


# launches, counted where the kernel is launched
LAUNCHES = {"wkv6": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]


def _overlap(a, b) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def wkv6(r, k, v, w, u, initial_state=None, *, out_state=None):
    """r, k, v (B,T,H,hd) in one dtype; w (B,T,H,hd) float32 or r's dtype
    (passed as it is: the decay exponent is not rounded to r's dtype); u
    (H,hd) float32; initial_state (B,H,hd,hd) float32 or None (zeros).
    Returns (y (B,T,H,hd) in r's dtype, final state (B,H,hd,hd) float32),
    the final state written into ``out_state`` when one is given (it may be
    ``initial_state`` itself). Launches the CUDA kernel on the current
    stream; raises on anything it does not take."""
    _build.check_cuda("wkv6", r=r, k=k, v=v, w=w, u=u,
                      initial_state=initial_state, out_state=out_state)
    _build.check_aligned("wkv6", r=r, k=k, v=v, w=w, u=u, **{
        n: s for n, s in (("initial_state", initial_state),
                          ("out_state", out_state)) if s is not None})
    b, t, h, n = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"wkv6: r/k/v/w shapes {tuple(r.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}/{tuple(w.shape)}")
    if n not in HEAD_DIMS:
        raise ValueError(f"wkv6: head_dim {n} not in {HEAD_DIMS}")
    if r.dtype not in RKV_DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype}:"
                         f" want one of {RKV_DTYPES} for all three")
    if w.dtype not in (torch.float32, r.dtype):
        raise ValueError(f"wkv6: w dtype {w.dtype}: want float32 or r's "
                         f"{r.dtype}")
    if u.dtype != torch.float32 or tuple(u.shape) != (h, n):
        raise ValueError(f"wkv6: u must be float32 ({h}, {n}), got "
                         f"{u.dtype} {tuple(u.shape)}")
    for name, s in (("initial_state", initial_state),
                    ("out_state", out_state)):
        if s is not None and (s.dtype != torch.float32
                              or tuple(s.shape) != (b, h, n, n)):
            raise ValueError(f"wkv6: {name} must be float32 ({b}, {h}, {n},"
                             f" {n}), got {s.dtype} {tuple(s.shape)}")
    if (initial_state is not None and out_state is not None
            and out_state.data_ptr() != initial_state.data_ptr()
            and _overlap(out_state, initial_state)):
        raise ValueError("wkv6: out_state overlaps initial_state without "
                         "being it")
    y = torch.empty_like(r)
    s_t = out_state if out_state is not None else torch.empty(
        (b, h, n, n), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    fn = _build.entry("wkv6", _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(),
             initial_state.data_ptr() if initial_state is not None else None,
             y.data_ptr(), s_t.data_ptr(), b, t, h, n,
             _build.dtype_code(r.dtype), _build.dtype_code(w.dtype), stream)
    if err:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    LAUNCHES["wkv6"] += 1
    return y, s_t
