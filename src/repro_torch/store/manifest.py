"""Chunked model manifests: the on-disk (or in-memory) layout behind the
cold-start data plane (a port of the reference's ``store/manifest.py``).

``save_model`` writes every param tensor as one raw-bytes chunk file, and
the manifest records, for every pipeline degree the model supports, which
stage owns which byte range of which chunk (via ``Model.stage_ranges``).
Period-stacked ``blocks/...`` leaves are row-major with the period axis
leading, so a stage's slice of a block chunk is a *contiguous byte range*
``[p0 * row_bytes, p1 * row_bytes)`` — a worker fetches exactly its
stage's bytes, never a slice of a live dict.

Roles mirror ``Model.slice_stage_params``:
  * ``block`` — period-stacked, split across stages by byte range;
  * ``first`` — embed leaves owned by stage 0;
  * ``last``  — final_norm / lm_head leaves owned by stage s-1.

The chunk order and paths are the reference's: its
``jax.tree_util.tree_flatten_with_path`` visits dict keys in sorted order,
and so does :func:`flatten_with_paths`. bfloat16 chunks are the tensors'
raw 16-bit words; the manifest names their dtype ``"bfloat16"`` as the
reference does, so each package reads a store the other wrote.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import encode_key, fsync_dir

MANIFEST_NAME = "manifest.json"
CHUNK_DIR = "chunks"
_LAST_ROOTS = ("final_norm", "lm_head")

# numpy has no bfloat16: its chunks are held as raw uint16 words
_NP_DTYPES = {"bfloat16": np.dtype(np.uint16)}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int8": torch.int8,
                 "int32": torch.int32}


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype a chunk's bytes are read as (bfloat16: uint16)."""
    return _NP_DTYPES.get(name) or np.dtype(name)


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


def host_array(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous host copy of a tensor as numpy (bfloat16 as its raw
    uint16 words), whose ``tobytes()`` are the chunk bytes."""
    h = t.detach().to("cpu", copy=True).contiguous()
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(np.uint16)
    return h.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def raw_leaf(t) -> Tuple[bytes, str, Tuple[int, ...]]:
    """A tensor's raw host bytes (those of ``host_array``: bfloat16 as its
    16-bit words), its torch dtype name and its shape."""
    t = torch.as_tensor(t)
    return host_array(t).tobytes(), _dtype_name(t), tuple(t.shape)


def flatten_with_paths(tree) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Leaves keyed by their path components, in sorted-key order (the
    order of the reference's ``jax.tree_util.tree_flatten_with_path``)."""
    out: Dict[Tuple[str, ...], torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        else:
            out[path] = node

    walk(tree, ())
    return out


def unflatten_paths(leaves: Dict[Tuple[str, ...], object]) -> dict:
    """Rebuild the nested-dict tree from path-component keys."""
    tree: dict = {}
    for path, leaf in leaves.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


@dataclass(frozen=True)
class ChunkRecord:
    """One tensor's chunk: raw little-endian bytes of the C-contiguous
    tensor, addressable by byte range."""
    index: int                       # manifest (stream) order
    path: Tuple[str, ...]            # tree path components
    file: str                        # chunk file name under chunks/
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    role: str                        # block | first | last

    @property
    def key(self) -> str:
        return "/".join(self.path)

    @property
    def row_bytes(self) -> int:
        """Bytes per leading-axis row (the period axis for block chunks)."""
        assert self.role == "block" and self.shape
        return self.nbytes // self.shape[0]


@dataclass(frozen=True)
class StageChunk:
    """One entry of a stage's fetch plan: a byte range of a chunk, plus
    the shape the range materializes to."""
    chunk: ChunkRecord
    offset: int
    length: int
    shape: Tuple[int, ...]


@dataclass
class Manifest:
    model: str
    dtype: str
    n_periods: int
    total_bytes: int
    chunks: List[ChunkRecord] = field(default_factory=list)
    # pipeline degree -> per-stage (p0, p1) period ranges
    stage_ranges: Dict[int, List[Tuple[int, int]]] = field(
        default_factory=dict)

    # ------------------------------------------------------------ queries
    @property
    def degrees(self) -> List[int]:
        return sorted(self.stage_ranges)

    def stage_plan(self, s: int, stage: int) -> List[StageChunk]:
        """The ordered byte ranges a stage-``stage`` worker of an s-way
        pipeline must fetch (manifest order == stream order)."""
        if s not in self.stage_ranges:
            raise KeyError(f"pipeline degree {s} not in manifest "
                           f"(has {self.degrees})")
        p0, p1 = self.stage_ranges[s][stage]
        plan: List[StageChunk] = []
        for c in self.chunks:
            if c.role == "block":
                if p1 <= p0:
                    continue
                rb = c.row_bytes
                plan.append(StageChunk(c, p0 * rb, (p1 - p0) * rb,
                                       (p1 - p0,) + tuple(c.shape[1:])))
            elif c.role == "first" and stage == 0:
                plan.append(StageChunk(c, 0, c.nbytes, tuple(c.shape)))
            elif c.role == "last" and stage == s - 1:
                plan.append(StageChunk(c, 0, c.nbytes, tuple(c.shape)))
        return plan

    def stage_bytes(self, s: int, stage: int) -> int:
        return sum(sc.length for sc in self.stage_plan(s, stage))

    # -------------------------------------------------------------- (de)ser
    def to_json(self) -> dict:
        return {
            "model": self.model, "dtype": self.dtype,
            "n_periods": self.n_periods, "total_bytes": self.total_bytes,
            "stage_ranges": {str(s): [list(r) for r in ranges]
                             for s, ranges in self.stage_ranges.items()},
            "chunks": [{
                "index": c.index, "path": list(c.path), "file": c.file,
                "dtype": c.dtype, "shape": list(c.shape),
                "nbytes": c.nbytes, "role": c.role,
            } for c in self.chunks],
        }

    @staticmethod
    def from_json(d: dict) -> "Manifest":
        return Manifest(
            model=d["model"], dtype=d["dtype"],
            n_periods=int(d["n_periods"]),
            total_bytes=int(d["total_bytes"]),
            chunks=[ChunkRecord(index=int(c["index"]),
                                path=tuple(c["path"]), file=c["file"],
                                dtype=c["dtype"], shape=tuple(c["shape"]),
                                nbytes=int(c["nbytes"]), role=c["role"])
                    for c in d["chunks"]],
            stage_ranges={int(s): [tuple(r) for r in ranges]
                          for s, ranges in d["stage_ranges"].items()})


def _role_of(path: Tuple[str, ...]) -> str:
    if path[0] == "blocks":
        return "block"
    if path[0] in _LAST_ROOTS:
        return "last"
    return "first"                   # embed


def build_manifest(model, params,
                   degrees=None) -> Tuple[Manifest,
                                          Dict[str, np.ndarray]]:
    """Chunk a live param tree (tensors on any device): returns the
    manifest plus ``file -> array`` (C-contiguous host copies whose
    ``tobytes()`` are the chunk bytes)."""
    cfg = model.cfg
    if degrees is None:
        degrees = range(1, cfg.n_periods + 1)
    leaves = flatten_with_paths(params)
    chunks: List[ChunkRecord] = []
    arrays: Dict[str, np.ndarray] = {}
    total = 0
    for i, (path, leaf) in enumerate(leaves.items()):
        arr = host_array(leaf)
        role = _role_of(path)
        if role == "block":
            assert arr.shape[0] == cfg.n_periods, \
                f"block leaf {'/'.join(path)} not period-stacked"
        fname = f"{i:04d}__{encode_key('/'.join(path))}.bin"
        chunks.append(ChunkRecord(index=i, path=path, file=fname,
                                  dtype=_dtype_name(leaf),
                                  shape=tuple(arr.shape),
                                  nbytes=arr.nbytes, role=role))
        arrays[fname] = arr
        total += arr.nbytes
    ranges = {int(s): [tuple(r) for r in model.stage_ranges(int(s))]
              for s in degrees}
    return Manifest(model=cfg.name, dtype=cfg.dtype,
                    n_periods=cfg.n_periods, total_bytes=total,
                    chunks=chunks, stage_ranges=ranges), arrays


def save_model(directory: str, model, params, degrees=None) -> Manifest:
    """Write the chunked store: ``chunks/*.bin`` raw tensors plus an
    atomically-committed ``manifest.json`` (temp file + fsync + rename +
    parent-dir fsync — a store without a manifest is not a store)."""
    manifest, arrays = build_manifest(model, params, degrees)
    cdir = os.path.join(directory, CHUNK_DIR)
    os.makedirs(cdir, exist_ok=True)
    for fname, arr in arrays.items():
        with open(os.path.join(cdir, fname), "wb") as f:
            f.write(memoryview(arr.reshape(-1)).cast("B"))
            f.flush()
            os.fsync(f.fileno())
    fsync_dir(cdir)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".manifest-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(manifest.to_json(), f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(directory, MANIFEST_NAME))
        fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return manifest


def load_manifest(directory: str) -> Manifest:
    with open(os.path.join(directory, MANIFEST_NAME)) as f:
        return Manifest.from_json(json.load(f))
