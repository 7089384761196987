"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C entry point, and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. The libraries go to
``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a hash of
every source in ``csrc/`` and the compiler flags, so an edited source
rebuilds at its first use and an unchanged one loads as it is. All missing
libraries are built together, one ``nvcc`` process per source.

Nothing here runs at import: the first kernel launch (or ``build_all``)
builds. There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# dtype codes of the C entry points (csrc/paged_attention_common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3}
# the body a C entry point with two bodies reports it launched, by code
BODIES = ("cuda_core", "tensor_core")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}


def _nvcc() -> str:
    from torch.utils import cpp_extension
    home = cpp_extension.CUDA_HOME
    cand = [str(Path(home) / "bin" / "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/csrc at first use and need the CUDA "
                       "toolkit (set CUDA_HOME)")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all() -> Dict[str, str]:
    """Compile every missing library, all ``nvcc`` processes started
    together. Returns {name: compiler log} of what was built (``-Xptxas
    -v``: registers, shared memory and spills per kernel)."""
    with _lock:
        todo = [n for n in sources() if not lib_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT,
                                              text=True))
        logs, failed = {}, []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            logs[n] = out
            if proc.returncode != 0:
                failed.append(n)
            else:
                os.replace(tmp, lib_path(n))
                lib_path(n).with_suffix(".log").write_text(out)
        if failed:
            raise RuntimeError("nvcc failed for "
                               + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def entry(name: str, argtypes):
    """The C entry point ``name`` of ``csrc/<name>.cu``, typed: pointers and
    the stream as ``c_void_p`` (a plain int would cut them to 32 bits)."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(library(name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def dtype_code(dt) -> int:
    return DTYPE_CODES[str(dt).replace("torch.", "")]


def check_cuda(name: str, **tensors):
    """The wrappers' device and contiguity checks: every tensor given (None
    skipped) lies on one CUDA device of capability 9.0 and is contiguous.
    Returns that device."""
    dev = None
    for k, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {k} must be a CUDA tensor, got "
                             f"{t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"{name}: the kernels are built for sm_90a "
                           f"(Hopper), got capability {cap}")
    return dev


def check_aligned(name: str, **tensors):
    """The kernels read pages in 16-byte vectors: each tensor given must
    start on a 16-byte boundary (a row of hd >= 16 values then does too)."""
    for k, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} must start on a 16-byte boundary")
