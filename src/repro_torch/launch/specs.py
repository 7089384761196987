"""Per-(arch x shape) input specs and sharding rules for the dry run, the
port of the reference's ``launch/specs.py``.

``make_cell`` returns the reference's five-tuple ``(fn, args,
in_shardings, out_shardings, donate)``: ``args`` are tensors on the
``meta`` device (global shapes), the shardings the port's
``NamedSharding``s on a ``DeviceMesh``. ``fn`` is the global program: run on
``args`` it gives the outputs' global shapes and dtypes, computing nothing.
``shard_shape`` and ``device_bytes`` read a sharding as the reference's
compiler lays an array out: each dim split over the mesh axes its entry
names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (NamedSharding, P, placements,
                                              resolve, use_mesh)
from repro_torch.models.common import tree_map
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt


def rules_for(shape: ShapeConfig, policy: str = "baseline",
              cfg: Optional[ModelConfig] = None) -> dict:
    """Logical-axis overrides per input shape.

    baseline: DP over batch, TP over heads/ffn/vocab/experts — the paper-
              faithful megatron-style layout; + sequence parallelism on the
              residual stream for train/prefill; + FSDP for archs whose
              TP=16 weight slice exceeds one chip's HBM.
    """
    rules: dict = {}
    if cfg is not None and cfg.fsdp:
        # weights' d_model dim additionally sharded over 'data'; activations
        # are unaffected ('batch' claims 'data' first in resolve())
        rules["embed"] = "data"
    if (shape.kind in ("train", "prefill") and shape.seq_len % 16 == 0
            and policy != "nosp"):
        # Megatron-style sequence parallelism on the residual stream: saved
        # (B,S,d) layer-boundary activations shard over 'model'
        rules["act_seq"] = "model"
    if shape.kind in ("decode", "prefill"):
        # KV-head counts (4/8/12/40) don't divide TP=16, so the KV cache
        # shards its *sequence* dim over 'model' (flash-decoding style SP).
        if shape.global_batch == 1:
            # long-context decode: batch unshardable; spread the cache over
            # every axis we have
            rules["batch"] = None
            rules["kv_seq"] = ("data", "model")
            rules["kv_heads"] = None
        else:
            rules["kv_seq"] = "model"
            rules["kv_heads"] = None
    return rules


def batch_sharding_spec(shape: ShapeConfig) -> P:
    if shape.kind == "decode" and shape.global_batch == 1:
        return P()
    return P(("pod", "data"))


def _fix1(mesh, s: P) -> NamedSharding:
    """Drop axes absent from this mesh (e.g. 'pod' on single-pod)."""
    names = mesh.mesh_dim_names
    parts = []
    for part in s:
        if part is None:
            parts.append(None)
            continue
        ax = (part,) if isinstance(part, str) else tuple(part)
        ax = tuple(a for a in ax if a in names)
        parts.append(ax if len(ax) > 1 else (ax[0] if ax else None))
    spec = P(*parts)
    return NamedSharding(mesh, spec, placements(mesh, spec))


def _named(mesh, spec_tree):
    return tree_map(lambda s: _fix1(mesh, s), spec_tree)


def make_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              policy: str = "baseline", remat: str = "full"):
    """Build (fn, arg_structs, in_shardings, out_shardings, donate) for one
    cell. The prefill's ``fn(params, batch)`` takes the reference's batch
    dict ({"tokens"}, and "patch_embeds" or "frames") and calls the port's
    ``Model.prefill(params, tokens, max_seq, paged=False, ...)``."""
    model = Model(cfg)
    rules = rules_for(shape, policy, cfg)
    # VLM: the assigned seq_len covers the full decoder context; the image
    # prefix occupies the first n_image_tokens of it
    text_seq = shape.seq_len - (cfg.n_image_tokens
                                if cfg.family == "vlm" else 0)
    with use_mesh(mesh, rules):
        p_sh = _named(mesh, model.specs())
        bspec = batch_sharding_spec(shape)

        if shape.kind == "train":
            from repro_torch.training.train_step import make_train_step
            step = make_train_step(model, remat=remat)
            batch_structs = model.input_structs(shape.global_batch, text_seq)
            batch_sh = tree_map(
                lambda s: _fix1(mesh, bspec if s.ndim >= 2 else P()),
                batch_structs)
            o_sh = _named(mesh, opt.state_specs(model.defs, zero1=True))
            args = (model.structs(), opt.state_structs(model.structs()),
                    batch_structs)
            return (step, args, (p_sh, o_sh, batch_sh), (p_sh, o_sh, None),
                    (0, 1))                       # donate params + opt

        if shape.kind == "prefill":
            def prefill_step(params, batch):
                return model.prefill(params, batch["tokens"], shape.seq_len,
                                     paged=False,
                                     prefix_embeds=batch.get("patch_embeds"),
                                     frames=batch.get("frames"))

            batch_structs = model.input_structs(shape.global_batch, text_seq)
            batch_sh = tree_map(lambda s: _fix1(mesh, bspec), batch_structs)
            cache_sh = _named(mesh, tree_map(resolve, model.cache_axes()))
            logits_sh = _fix1(mesh, P(("pod", "data")))
            return (prefill_step, (model.structs(), batch_structs),
                    (p_sh, batch_sh), (logits_sh, cache_sh), ())

        # decode: one new token against a cache of seq_len
        cache_structs = model.init_cache(shape.global_batch, shape.seq_len,
                                         as_structs=True)
        cache_sh = _named(mesh, tree_map(resolve, model.cache_axes()))

        def serve_step(params, cache, tokens, positions):
            return model.decode_step(params, cache, tokens, positions)

        tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                          device="meta")
        tok_sh = _fix1(mesh, bspec)
        logits_sh = _fix1(
            mesh, P() if shape.global_batch == 1 else P(("pod", "data")))
        args = (model.structs(), cache_structs, tok, tok.clone())
        return (serve_step, args, (p_sh, cache_sh, tok_sh, tok_sh),
                (logits_sh, cache_sh), (1,))     # donate the cache


def shard_shape(shape, sharding: Optional[NamedSharding],
                axes: Optional[tuple] = None) -> tuple:
    """One rank's shape of a global ``shape`` under ``sharding``: each dim
    divided by the sizes of the mesh axes its spec entry names (only those
    in ``axes``, if given), rounded up as an uneven split's largest piece.
    ``None`` is replicated."""
    if sharding is None:
        return tuple(shape)
    mesh, out = sharding.mesh, list(shape)
    names = mesh.mesh_dim_names
    for dim, part in enumerate(sharding.spec):
        if part is None:
            continue
        n = math.prod(mesh.size(names.index(a)) for a in (
            (part,) if isinstance(part, str) else part)
            if axes is None or a in axes)
        out[dim] = -(-out[dim] // n)
    return tuple(out)


def map_sharded(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree of tensors (dicts, tuples, lists)
    whose shardings' tree mirrors it, or stops at one ``NamedSharding`` or
    ``None`` (replicated) for a whole subtree."""
    def sub(key):
        if shardings is None or isinstance(shardings, NamedSharding):
            return shardings
        return shardings[key]

    if isinstance(tree, dict):
        return {k: map_sharded(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_sharded(fn, t, sub(i))
                          for i, t in enumerate(tree))
    return None if tree is None else fn(tree, shardings)


def local_structs(tree, shardings, axes: Optional[tuple] = None):
    """``tree`` with each tensor replaced by one rank's shard of it on the
    ``meta`` device (``shard_shape``)."""
    return map_sharded(lambda t, s: torch.empty(
        shard_shape(t.shape, s, axes), dtype=t.dtype, device="meta"),
        tree, shardings)


def device_bytes(tree, shardings) -> int:
    """Bytes one rank holds of ``tree`` under ``shardings``."""
    sizes = []
    map_sharded(lambda t, s: sizes.append(
        math.prod(shard_shape(t.shape, s)) * t.element_size()),
        tree, shardings)
    return sum(sizes)
