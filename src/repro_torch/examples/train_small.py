"""Train a small dense LM (the reference example's "~100M" config) for a
few hundred steps with the full production train step (AdamW, ZeRO-1
specs, remat, checkpointing), demonstrating fault-tolerant restart: run
it again and it resumes from its last checkpoint. The twin of the
reference's ``examples/train_small.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_small \\
        [--steps 200] [--device cpu] [--ckpt-dir DIR] [--fresh]

Runs on the card unless ``--device cpu`` is given. Checkpoints go to
``--ckpt-dir`` (default: ``_train_small/`` at the root of the checkout).
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticTokens
from repro_torch.training.train_step import make_train_step

CKPT_DIR = str(Path(__file__).resolve().parents[3] / "_train_small")


def small_config():
    return ModelConfig(
        name="demo-100m", family="dense", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=4, d_ff=2048, vocab=8192, dtype="float32")


def main(steps: int = 200, batch: int = 8, seq: int = 128,
         fresh: bool = False, device=None, ckpt_dir: str = CKPT_DIR):
    """Train to ``steps`` on ``device`` (default: the card), resuming from
    the last checkpoint in ``ckpt_dir``. Returns the metrics of each step
    run, by step."""
    dev = resolve_device(device)
    if fresh and Path(ckpt_dir).exists():
        shutil.rmtree(ckpt_dir)

    cfg = small_config()
    model = Model(cfg)
    print(f"params: {model.bytes()/4/1e6:.1f}M")
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    state = opt.init_state(params)

    ckpt = CheckpointManager(ckpt_dir, keep=2)
    start = 0
    if ckpt.latest_step() is not None:
        (params, state), manifest = ckpt.restore((params, state))
        start = manifest["step"]
        print(f"restored checkpoint at step {start} (fault-tolerant resume)")

    step_fn = make_train_step(
        model, opt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps),
        remat="none", grad_dtype=None)
    data = iter(SyntheticTokens(cfg, batch, seq, seed=1))

    t0 = time.time()
    history = {}
    for step in range(start, steps):
        params, state, metrics = step_fn(params, state, next(data))
        history[step] = metrics
        if step % 20 == 0 or step == steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)")
        if step and step % 50 == 0:
            path = ckpt.save(step, (params, state))
            print(f"  checkpoint -> {path}")
    ckpt.save(steps, (params, state))
    print("done; rerun without --fresh to resume from the last checkpoint")
    return history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    a = ap.parse_args()
    main(a.steps, a.batch, a.seq, a.fresh, a.device, a.ckpt_dir)
