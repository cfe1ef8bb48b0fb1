"""Utilities of the port (counterpart of bigdl_tpu/utils): the 1-based
Table, the random streams, the engine, module and snapshot files, the
Torch7 and Caffe weight import, the model broadcast and logging."""
from bigdl_tpu_torch.parallel.broadcast import \
    model_broadcast as ModelBroadcast
from bigdl_tpu_torch.utils import caffe_loader as CaffeLoader
from bigdl_tpu_torch.utils import file as File
from bigdl_tpu_torch.utils import torch_file as TorchFile
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["CaffeLoader", "Engine", "File", "ModelBroadcast",
           "RandomGenerator", "T", "Table", "TorchFile", "kth_largest"]


def kth_largest(values, k):
    """The k-th largest value (1-based k; ref utils/Util.kthLargest,
    Util.scala:21), the straggler threshold's quickselect."""
    import numpy as np

    arr = np.asarray(values).reshape(-1)
    return float(np.partition(arr, len(arr) - k)[len(arr) - k])
