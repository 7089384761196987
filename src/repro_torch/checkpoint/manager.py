"""Fault-tolerant checkpointing: atomic commit (write temp dir + manifest +
rename), keep-last-k retention, restore-latest. Tree leaves (tensors,
numpy arrays or numbers) are stored as individual .npy files keyed by
their tree path, as in the reference, so either package reads the
other's checkpoints of float32 and int32 trees.

numpy has no bfloat16: a bfloat16 tensor is stored as its raw 16-bit
words (``uint16``) with ``"bfloat16"`` as its dtype in the manifest, as
the store's chunks and the KV segment tier hold it, and restored bit for
bit.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import urllib.parse
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten_with_paths(tree) -> Dict[str, Any]:
    """Leaves keyed by their "/"-joined path, in the order of the
    reference's ``jax.tree_util.tree_flatten_with_path``: dict keys sorted,
    list and tuple items by index."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(tree, ())
    return out


def _unflatten_like(template, leaves: Dict[str, Any], path=()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, leaves, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, leaves, path + (str(i),))
                              for i, v in enumerate(template))
    return leaves["/".join(path)]


def encode_key(key: str) -> str:
    """Collision-free, filename-safe encoding of a tree-path key.
    Percent-encoding is injective — ``%`` itself is always escaped — so
    distinct keys always get distinct file names (``{"a__b": x}`` and
    ``{"a": {"b": y}}`` do not collide). Restore never needs a decoder:
    manifests record the original key next to the encoded file name."""
    return urllib.parse.quote(key, safe="")


def fsync_dir(path: str):
    """fsync a directory so a just-committed rename survives a crash.
    Without this the directory entry for an ``os.rename`` commit can
    still be lost on power failure even though the file contents were
    fsynced. Best-effort on platforms that refuse O_RDONLY on dirs."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                      # e.g. Windows
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host(leaf):
    """(numpy array written to disk, manifest dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        h = leaf.detach().to("cpu").contiguous()
        if h.dtype == torch.bfloat16:
            return h.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = h.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _restore_leaf(arr: np.ndarray, dtype_name: str, like):
    """A stored array as the template leaf ``like`` holds it: a tensor on
    its device and dtype, a numpy array of its dtype, else the array."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = None
    if isinstance(like, torch.Tensor):
        if t is None:
            t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(device=like.device, dtype=like.dtype)
    if hasattr(like, "dtype"):
        if t is not None:
            return t.float().numpy().astype(like.dtype)
        return arr.astype(like.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # --------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        leaves = _flatten_with_paths(tree)
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp-")
        manifest = {"step": int(step), "leaves": [], "extra": extra or {}}
        try:
            for key, leaf in leaves.items():
                arr, dtype_name = _host(leaf)
                fname = encode_key(key) + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append(
                    {"key": key, "file": fname, "dtype": dtype_name,
                     "shape": list(arr.shape)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # atomic commit...
            fsync_dir(self.dir)          # ...durable only once the parent
        except BaseException:            #    directory entry is on disk
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                # only committed checkpoints (manifest present) count
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None):
        """Restore into the structure of ``template`` (values replaced):
        each tensor leaf comes back on the template leaf's device and in
        its dtype. Returns (tree, manifest), or (None, None) when no
        checkpoint is committed."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}
        leaves = {}
        for key, like in _flatten_with_paths(template).items():
            entry = by_key[key]
            arr = np.load(os.path.join(d, entry["file"]))
            leaves[key] = _restore_leaf(arr, entry["dtype"], like)
        return _unflatten_like(template, leaves), manifest
