"""Train step: the loss and its gradients over ``Model.loss``, bf16
gradient compression, the AdamW update. The port of the reference's
``training/train_step.py``; where the reference takes
``jax.value_and_grad``, the port marks the param leaves ``requires_grad``
and takes ``torch.autograd.grad``. A step runs on the device its params
are on: on the card, attention goes through the flash kernel (forward) and
the plain version's autodiff (backward; ``kernels/ops.py::_FlashFn``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import (as_dtype, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt


def loss_and_grads(model: Model, params, batch, *, remat: str = "none"):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: the grads a
    tree like ``params``, each leaf in its param's dtype. ``params`` are
    left as they were (the loss runs on detached leaves)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(leaves, batch, remat=remat)
    # a leaf the loss never reads (a cross-attention block's own norm) gets
    # zeros, as under jax.grad
    grads = tree_unflatten(leaves, torch.autograd.grad(
        loss, tree_leaves(leaves), materialize_grads=True))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(model: Model, cfg: opt.AdamWConfig = opt.AdamWConfig(),
                    remat: str = "dots",
                    grad_dtype: Optional[str] = "bfloat16"):
    """``train_step(params, state, batch) -> (params, state, metrics)``:
    metrics {"ce", "aux", "loss", "grad_norm", "lr"}, scalars on the
    params' device."""
    gd = as_dtype(grad_dtype) if grad_dtype is not None else None

    def train_step(params, state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch,
                                              remat=remat)
        if gd is not None:
            # gradient compression: cross-replica reduction happens in bf16
            grads = tree_map(lambda g: g.to(gd), grads)
        params, state, om = opt.apply_updates(cfg, params, grads, state)
        return params, state, dict(metrics, loss=loss, **om)

    return train_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return dict(metrics, loss=loss)
    return eval_step
