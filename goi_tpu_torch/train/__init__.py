from goi_tpu_torch.train.optim import (OptimConfig, expon_lr_schedule,
                                       make_full_training_optimizer,
                                       make_scene_optimizer)

__all__ = ["OptimConfig", "make_scene_optimizer",
           "make_full_training_optimizer", "expon_lr_schedule"]
