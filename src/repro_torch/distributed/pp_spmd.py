"""Pipeline-parallel prefill on ``torch.distributed``: a GPipe-style
micro-batched prefill over a ``("stage", "data", "model")`` mesh, the port
of the reference's ``distributed/pp_spmd.py`` (there one ``shard_map`` over
the ``"stage"`` axis, stages exchanging activations by ``ppermute``).

Each rank of the mesh's ``"stage"`` group runs ``fn`` on its contiguous
slice of the stacked period axis (``transformer.stage_period_ranges``,
``Model.slice_stage_params``: the slice a cold-start worker fetches).
The schedule has ``n_micro + n_stages - 1`` ticks; at tick t stage s runs
micro-batch t - s, if there is one: stage 0 embeds it, every other stage
receives it from the stage before; then its periods; the last stage takes
the head of its last token, every other stage sends the activation on.
The last stage's logits are all-reduced (in float32, as the reference's
``psum``) so every stage returns them.

Where the reference runs the SPMD program's every step on every stage
(embed and head on each, blocks through the pipeline's bubbles, and a ring
permutation whose wrap to stage 0 is discarded), the port computes only
what is kept: the same results. The exchanges form a chain (s to s + 1),
so each tick's send and receive are posted together as ``isend``/``irecv``
and waited on; no cycle can deadlock (``batch_isend_irecv`` refuses the
dry run's ``meta`` tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (NamedSharding, P, placements,
                                              use_mesh)
from repro_torch.models import transformer
from repro_torch.models.common import as_dtype, tree_leaves, tree_map
from repro_torch.models.model import Model


def supports(cfg: ModelConfig, n_stages: int = 4) -> bool:
    return (not cfg.is_encdec and cfg.n_periods % n_stages == 0
            and cfg.family in ("dense", "vlm", "moe"))


def make_pp_prefill(cfg: ModelConfig, mesh, batch: int, seq: int,
                    n_stages: int = 4, n_micro: int = 8):
    """Returns (fn, arg_structs, in_shardings, out_shardings, donate), as
    the reference's. ``fn(params, tokens)`` is one stage's function under
    the mesh's ``"stage"`` group: ``params`` the stage's slice
    (``Model.slice_stage_params``; the embedding on stage 0, the final norm
    and lm_head on the last), ``tokens`` (B, ``seq``) the data rank's rows,
    cut into ``n_micro`` micro-batches. It returns the last token's logits
    (B, padded_vocab) on every stage. ``arg_structs`` are the global shapes
    on the ``meta`` device, the shardings ``NamedSharding``s on ``mesh``
    (the stacked period axis over ``"stage"``)."""
    if not supports(cfg, n_stages):
        raise ValueError(f"{cfg.name}: the pipelined prefill at {n_stages} "
                         f"stages is not supported")
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not split into {n_micro} "
                         f"micro-batches")
    have = mesh.size(mesh.mesh_dim_names.index("stage"))
    if have != n_stages:
        raise ValueError(f"the mesh's stage axis has {have} ranks, not "
                         f"{n_stages} stages")
    dt = as_dtype(cfg.dtype)

    def fn(params, tokens):
        pg = mesh.get_group("stage")
        stage = mesh.get_local_rank("stage")
        last = n_stages - 1
        dev = tree_leaves(params["blocks"])[0].device
        b = tokens.shape[0]
        mb = b // n_micro
        mbs = tokens.to(dev).reshape(n_micro, mb, seq)
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=dev)[None].expand(mb, seq)
        logits = torch.zeros((n_micro, mb, cfg.padded_vocab),
                             dtype=torch.float32, device=dev)
        prev = (dist.get_global_rank(pg, stage - 1) if stage > 0 else None)
        nxt = (dist.get_global_rank(pg, stage + 1) if stage < last else None)
        out = None                      # the activation of the last tick
        for t in range(n_micro + n_stages - 1):
            m = t - stage
            reqs, x = [], None
            if out is not None:         # micro-batch m - 1, to stage + 1
                reqs.append(dist.isend(out, nxt, group=pg))
            if 0 <= m < n_micro and stage > 0:
                x = torch.empty((mb, seq, cfg.d_model), dtype=dt, device=dev)
                reqs.append(dist.irecv(x, prev, group=pg))
            for r in reqs:
                r.wait()
            out = None
            if not 0 <= m < n_micro:
                continue
            if stage == 0:
                x = transformer.embed(cfg, params, mbs[m], positions,
                                      dtype=dt)
            x, _, _ = transformer.run_blocks(cfg, params["blocks"], x,
                                             positions)
            if stage == last:
                logits[m] = transformer.head(cfg, params, x[:, -1]).float()
            else:
                out = x.contiguous()
        # the last stage's logits on every stage
        dist.all_reduce(logits, group=pg)
        return logits.to(dt).reshape(b, cfg.padded_vocab)

    model = Model(cfg)
    with use_mesh(mesh, {"layers": "stage", "batch": ("data",)}):
        full_specs = model.specs()
    ns = lambda s: NamedSharding(mesh, s, placements(mesh, s))  # noqa: E731
    tok = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return (fn, (model.structs(), tok),
            (tree_map(ns, full_specs), ns(P("data"))), ns(P("data", "model")),
            ())
