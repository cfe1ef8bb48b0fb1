"""Training of the port (counterpart of bigdl_tpu/optim): OptimMethods
(SGD, Adagrad, L-BFGS), triggers, validation methods and validators, the
host timers, the local and the data-parallel optimizer, straggler
dropping and the checkpoint helpers."""
from bigdl_tpu_torch.optim import trigger as Trigger
from bigdl_tpu_torch.optim.distri_optimizer import (DistriOptimizer,
                                                    global_batch_rule)
from bigdl_tpu_torch.optim.lbfgs import LBFGS
from bigdl_tpu_torch.optim.local_optimizer import (LocalOptimizer,
                                                   NonFiniteGradError,
                                                   distri_validate, validate)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (SGD, Adagrad, Default,
                                                EpochDecay,
                                                EpochSchedule, EpochStep,
                                                LearningRateSchedule,
                                                OptimMethod, Poly, Step)
from bigdl_tpu_torch.optim.optimizer import (Optimizer,
                                             is_distributed_dataset,
                                             list_checkpoints,
                                             load_latest_checkpoint,
                                             prune_checkpoints, save_model,
                                             save_state, snapshot_files,
                                             snapshot_valid)
from bigdl_tpu_torch.optim.straggler import StragglerPolicy
from bigdl_tpu_torch.optim.trigger import (every_epoch, max_epoch,
                                           max_iteration, min_loss,
                                           several_iteration)
from bigdl_tpu_torch.optim.validation import (AccuracyResult,
                                              EvaluateMethods, Loss,
                                              LossResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.optim.validator import (DistriValidator, LocalValidator,
                                             Validator)

__all__ = [
    "AccuracyResult", "Adagrad", "Default", "DistriOptimizer",
    "DistriValidator", "EpochDecay", "EpochSchedule", "EpochStep",
    "EvaluateMethods", "LBFGS",
    "LearningRateSchedule", "LocalOptimizer", "LocalValidator", "Loss",
    "LossResult",
    "Metrics", "NonFiniteGradError", "OptimMethod", "Optimizer", "Poly",
    "SGD", "Step", "StragglerPolicy", "Top1Accuracy", "Top5Accuracy",
    "Trigger",
    "ValidationMethod", "ValidationResult", "Validator",
    "distri_validate", "every_epoch",
    "global_batch_rule", "is_distributed_dataset",
    "list_checkpoints", "load_latest_checkpoint", "max_epoch",
    "max_iteration", "min_loss", "prune_checkpoints", "save_model",
    "save_state", "several_iteration", "snapshot_files", "snapshot_valid",
    "validate",
]
