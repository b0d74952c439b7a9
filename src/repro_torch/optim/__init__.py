"""Optimizers and learning-rate schedules (the port of ``repro/optim``)."""
from repro_torch.optim.adam import AdamState, adam
from repro_torch.optim.schedule import (Schedule, constant,
                                        linear_warmup_cosine, step_decay)
from repro_torch.optim.sgd import MomentumState, SGDState, momentum_sgd, sgd

__all__ = ["AdamState", "MomentumState", "SGDState", "Schedule", "adam",
           "constant", "linear_warmup_cosine", "momentum_sgd", "sgd",
           "step_decay"]
