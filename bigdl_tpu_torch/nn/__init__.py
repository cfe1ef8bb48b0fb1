"""Torch-style layers of the port (counterpart of bigdl_tpu/nn)."""
from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU, Tanh
from bigdl_tpu_torch.nn.attention import (MultiHeadSelfAttention,
                                          SinusoidalPositionalEncoding)
from bigdl_tpu_torch.nn.containers import Concat, ConcatTable, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          CrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.init import Default, Xavier
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Module, TensorModule
from bigdl_tpu_torch.nn.normalization import LayerNorm, SpatialCrossMapLRN
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.recurrent import (BiRecurrent, Cell, GRUCell,
                                          LSTMCell, Recurrent, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.reductions import Mean
from bigdl_tpu_torch.nn.shape_ops import Identity, Reshape, View
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = [
    "BiRecurrent", "CAddTable", "Cell", "ClassNLLCriterion", "Concat",
    "ConcatTable", "Container", "Criterion", "CrossEntropyCriterion",
    "Default", "Dropout", "GRUCell", "Identity", "LSTMCell", "LayerNorm",
    "Linear", "LogSoftMax", "Mean", "Module", "MultiHeadSelfAttention",
    "Recurrent", "ReLU", "Reshape", "RnnCell", "Sequential",
    "SinusoidalPositionalEncoding", "SpatialAveragePooling",
    "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling", "Tanh",
    "TensorModule", "TimeDistributed", "TimeDistributedCriterion", "View",
    "Xavier",
]
