"""Training of the port (counterpart of bigdl_tpu/optim): OptimMethods,
triggers, validation methods, the host timers and the local optimizer."""
from bigdl_tpu_torch.optim import trigger as Trigger
from bigdl_tpu_torch.optim.local_optimizer import (LocalOptimizer,
                                                   NonFiniteGradError,
                                                   validate)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (SGD, Default, EpochDecay,
                                                EpochSchedule, EpochStep,
                                                LearningRateSchedule,
                                                OptimMethod, Poly, Step)
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import (every_epoch, max_epoch,
                                           max_iteration, min_loss,
                                           several_iteration)
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)

__all__ = [
    "AccuracyResult", "Default", "EpochDecay", "EpochSchedule", "EpochStep",
    "LearningRateSchedule", "LocalOptimizer", "Loss", "LossResult",
    "Metrics", "NonFiniteGradError", "OptimMethod", "Optimizer", "Poly",
    "SGD", "Step", "Top1Accuracy", "Top5Accuracy", "Trigger",
    "ValidationMethod", "ValidationResult", "every_epoch", "max_epoch",
    "max_iteration", "min_loss", "several_iteration", "validate",
]
