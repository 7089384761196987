"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
repository's root. Tests marked ``cuda`` need the card and skip without
one. Each test process keeps to two threads, so that the tiny windows
of the CPU runs serve their requests when pytest runs several processes
on a busy machine."""

import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parents[2]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
