"""Training of the port (counterpart of bigdl_tpu/optim): OptimMethods,
triggers, validation methods, the host timers, the local and the
data-parallel optimizer, straggler dropping and the checkpoint
helpers."""
from bigdl_tpu_torch.optim import trigger as Trigger
from bigdl_tpu_torch.optim.distri_optimizer import (DistriOptimizer,
                                                    global_batch_rule)
from bigdl_tpu_torch.optim.local_optimizer import (LocalOptimizer,
                                                   NonFiniteGradError,
                                                   validate)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (SGD, Default, EpochDecay,
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
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)

__all__ = [
    "AccuracyResult", "Default", "DistriOptimizer", "EpochDecay",
    "EpochSchedule", "EpochStep",
    "LearningRateSchedule", "LocalOptimizer", "Loss", "LossResult",
    "Metrics", "NonFiniteGradError", "OptimMethod", "Optimizer", "Poly",
    "SGD", "Step", "StragglerPolicy", "Top1Accuracy", "Top5Accuracy",
    "Trigger",
    "ValidationMethod", "ValidationResult", "every_epoch",
    "global_batch_rule", "is_distributed_dataset",
    "list_checkpoints", "load_latest_checkpoint", "max_epoch",
    "max_iteration", "min_loss", "prune_checkpoints", "save_model",
    "save_state", "several_iteration", "snapshot_files", "snapshot_valid",
    "validate",
]
