from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm,
                                          cosine_schedule, make_optimizer,
                                          momentum_sgd, sgd)

__all__ = ["Optimizer", "adamw", "momentum_sgd", "sgd", "apply_updates",
           "clip_by_global_norm", "cosine_schedule", "make_optimizer"]
