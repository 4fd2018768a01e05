"""GAN training: the configuration, the train state, the step and the
Trainer (counterparts of ``sg2im_tpu/train/``)."""

from sg2im_tpu_torch.train.config import TrainConfig
from sg2im_tpu_torch.train.state import AdamState, TrainState
from sg2im_tpu_torch.train.trainer import Trainer

__all__ = ["AdamState", "TrainConfig", "TrainState", "Trainer"]
