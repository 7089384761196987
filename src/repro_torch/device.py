"""Device resolution shared by the port's entry points.

Entry points (``Engine``, ``StageWorker``, ``Model.init``,
``convert.params_from_numpy``) take ``device=None`` to mean the CUDA card.
On a machine without one that default raises: the port never drops to the
CPU on its own, the caller asks for it with ``device="cpu"``."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
