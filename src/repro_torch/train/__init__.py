from repro_torch.train.state import make_train_step
from repro_torch.train.trainer import Trainer

__all__ = ["Trainer", "make_train_step"]
