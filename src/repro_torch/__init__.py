"""PyTorch/CUDA port of the HydraServe reproduction.

Mirrors ``src/repro`` module for module, held against it by the
``tests/test_torch_*.py`` parity tests. The port imports ``torch``,
``numpy`` and the standard library only: nothing of JAX and nothing of the
reference package. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``; every hand-written kernel's plain PyTorch version
serves CPU tensors (see ``kernels/ops.py``).
"""

from repro_torch.device import resolve_device  # noqa: F401
