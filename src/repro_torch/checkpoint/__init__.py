"""Checkpoints of the port in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "AsyncCheckpointer"]
