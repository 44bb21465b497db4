from repro_torch.train.state import make_train_step

__all__ = ["make_train_step"]
