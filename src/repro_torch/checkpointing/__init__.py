from repro_torch.checkpointing.checkpoint import (AsyncCheckpointer,
                                                  CheckpointError,
                                                  CheckpointIOError,
                                                  gc_checkpoints, latest_step,
                                                  latest_valid_step,
                                                  list_steps, load_meta,
                                                  restore_checkpoint,
                                                  save_checkpoint, snapshot,
                                                  validate_checkpoint,
                                                  write_snapshot)

__all__ = [
    "AsyncCheckpointer", "CheckpointError", "CheckpointIOError",
    "gc_checkpoints", "latest_step", "latest_valid_step", "list_steps",
    "load_meta", "restore_checkpoint", "save_checkpoint", "snapshot",
    "validate_checkpoint", "write_snapshot",
]
