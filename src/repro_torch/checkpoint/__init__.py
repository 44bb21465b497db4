from repro_torch.checkpoint.checkpoint import (latest_step, restore,
                                               restore_params, save,
                                               verify_step)

__all__ = ["latest_step", "restore", "restore_params", "save",
           "verify_step"]
