"""Step-indexed checkpoints (the reference's directory format)."""

from repro_torch.checkpoint.manager import (CheckpointManager, restore_pytree,
                                            save_pytree)

__all__ = ["CheckpointManager", "restore_pytree", "save_pytree"]
