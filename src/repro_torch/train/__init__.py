"""Training: the trainer and its loop, checkpoints, fault recovery (the
port of ``repro.train``)."""
from repro_torch.train.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.train.fault import (FailureInjector,  # noqa: F401
                                     PreemptionError, StragglerMonitor,
                                     run_with_recovery)
from repro_torch.train.loop import TrainConfig, Trainer, quick_train  # noqa: F401
