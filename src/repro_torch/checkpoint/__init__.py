"""Checkpointing: atomic versioned save/restore with an async writer (the
port of ``repro.checkpoint``, on the JAX package's on-disk format)."""
from repro_torch.checkpoint.manager import (CheckpointManager, leaf_names,
                                            named_leaves)

__all__ = ["CheckpointManager", "leaf_names", "named_leaves"]
