from .checkpointer import (
    AsyncCheckpointer,
    latest_checkpoint,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "AsyncCheckpointer", "latest_checkpoint", "list_checkpoints",
    "restore_checkpoint", "save_checkpoint",
]
