"""Weight interchange with the reference package.

``params_from_numpy`` takes the reference's params as a nested dict of
numpy arrays — what ``jax.tree.map(np.asarray, Model(cfg).init(key))``
gives — and returns the port's params with the same keys and the same
bits. numpy has no bfloat16 of its own: a bfloat16 array (``ml_dtypes``'
type, which JAX hands out) is read as its raw 16-bit words and viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")         # writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)
