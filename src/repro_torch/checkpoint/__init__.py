from repro_torch.checkpoint.checkpoint import (CheckpointManager,  # noqa: F401
                                               latest_step, restore, save)
