"""Synthetic token pipeline: deterministic, shardable, no I/O dependency.
Produces batches shaped like the assigned train shapes; real deployments
would swap in a tokenized corpus reader behind the same iterator API."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticTokens:
    """Zipf-distributed token stream with a fixed seed; yields dicts matching
    Model.input_structs."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        ranks = self.rng.zipf(1.3, size=(self.batch, self.seq))
        tokens = np.minimum(ranks, cfg.vocab - 1).astype(np.int32)
        out = {"tokens": tokens}
        if cfg.family == "vlm":
            out["patch_embeds"] = self.rng.standard_normal(
                (self.batch, cfg.n_image_tokens, cfg.d_model)).astype(
                np.float32) * 0.02
        if cfg.is_encdec:
            out["frames"] = self.rng.standard_normal(
                (self.batch, cfg.n_audio_frames, cfg.d_model)).astype(
                np.float32) * 0.02
        return out
