"""Training substrate: trainer loop, checkpointing, fault tolerance."""

from repro_torch.train.checkpoints import CheckpointManager  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainConfig  # noqa: F401
