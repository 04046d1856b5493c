"""Training runtime: optimizer, loop, checkpointing, compression, watchdog.

Port of ``repro/training``, exporting what the reference's exports."""

from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        init_opt_state, lr_at)
from repro_torch.training.loop import TrainConfig, make_train_step, train
from repro_torch.training.checkpoint import (save_checkpoint,
                                             restore_checkpoint,
                                             latest_step, AsyncCheckpointer)
from repro_torch.training.watchdog import StepWatchdog

__all__ = ["AdamWConfig", "AsyncCheckpointer", "StepWatchdog",
           "TrainConfig", "adamw_update", "init_opt_state", "latest_step",
           "lr_at", "make_train_step", "restore_checkpoint",
           "save_checkpoint", "train"]
