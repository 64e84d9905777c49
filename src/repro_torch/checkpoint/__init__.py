from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    CorruptCheckpointError,
    Snapshot,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "CorruptCheckpointError",
    "Snapshot",
    "load_checkpoint",
    "save_checkpoint",
]
