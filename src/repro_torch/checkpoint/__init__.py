"""Fault-tolerant checkpoints of tensor trees (the port of the reference's
``checkpoint`` package)."""

from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            encode_key, fsync_dir)

__all__ = ["CheckpointManager", "encode_key", "fsync_dir"]
