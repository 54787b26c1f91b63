from repro_torch.checkpoint.npz import (CheckpointCorruptionError,
                                        latest_checkpoint, load_state,
                                        save_state)

__all__ = ["CheckpointCorruptionError", "save_state", "load_state",
           "latest_checkpoint"]
