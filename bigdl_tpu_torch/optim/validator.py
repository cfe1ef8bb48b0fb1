"""Validator classes (counterpart of bigdl_tpu/optim/validator.py; ref
optim/Validator.scala:24, LocalValidator.scala:30,
DistriValidator.scala:32).

``Validator(model, dataset).test(methods)`` evaluates outside the
training loop and returns ``[(method, result)]``.  The factory picks the
local or the distributed evaluation by the dataset's type, as the JAX
one does: a rank's shard (``ShardedDataSet``, or a chain over one)
evaluates on every rank and merges the results over the process group
(:func:`~bigdl_tpu_torch.optim.local_optimizer.distri_validate`).  The
model runs on ``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from bigdl_tpu_torch.dataset.dataset import is_distributed_dataset
from bigdl_tpu_torch.optim.local_optimizer import distri_validate, validate
from bigdl_tpu_torch.utils.device import resolve_device


class Validator:
    """Evaluate ``model`` over ``dataset`` (ref Validator.scala:24)."""

    def __init__(self, model, dataset, device="cuda"):
        self.model = model
        self.dataset = dataset
        self.device = resolve_device(device)

    def _distributed(self) -> bool:
        return is_distributed_dataset(self.dataset)

    def test(self, methods, params=None, net_state=None):
        """Run every ValidationMethod over the dataset; ``[(method,
        result)]`` (ref Validator.test).  ``params`` / ``net_state`` (trees
        in the JAX layout), where given, are copied into the model
        first."""
        if params is not None:
            self.model.load_params(params)
        if net_state is not None:
            self.model.load_state(net_state)
        self.model.to(self.device)
        if self._distributed():
            return distri_validate(self.model, self.dataset, methods,
                                   self.device)
        return validate(self.model, self.dataset, methods, self.device)


class LocalValidator(Validator):
    """Single-process evaluation (ref LocalValidator.scala:30)."""

    def _distributed(self) -> bool:
        return False


class DistriValidator(Validator):
    """Evaluation over the process group with the results merged (ref
    DistriValidator.scala:32)."""

    def _distributed(self) -> bool:
        return True
