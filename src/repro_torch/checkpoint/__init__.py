"""Crash-safe checkpoints of tensor and numpy trees, in the JAX package's
on-disk format (:mod:`repro_torch.checkpoint.store`)."""
from repro_torch.checkpoint.store import (CheckpointCorrupt, latest_step,
                                          load_manifest, restore,
                                          restore_extra, save, steps)

__all__ = ["CheckpointCorrupt", "latest_step", "load_manifest", "restore",
           "restore_extra", "save", "steps"]
