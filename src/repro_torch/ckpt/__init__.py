from repro_torch.ckpt.checkpoint import Checkpointer, CheckpointError  # noqa: F401
from repro_torch.ckpt.recovery import (RecoveryManager,  # noqa: F401
                                       RestoreOutcome, SimTrainState)
