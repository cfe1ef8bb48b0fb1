"""Torch-style layers of the port (counterpart of bigdl_tpu/nn)."""
from bigdl_tpu_torch.nn.activations import (
    ELU, Abs, Clamp, Exp, GradientReversal, HardShrink, HardTanh, LeakyReLU,
    Log, LogSigmoid, LogSoftMax, Power, PReLU, ReLU, ReLU6, RReLU, Sigmoid,
    SoftMax, SoftMin, SoftPlus, SoftShrink, SoftSign, Sqrt, Square, Tanh,
    TanhShrink, Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadSelfAttention,
                                          SinusoidalPositionalEncoding)
from bigdl_tpu_torch.nn.containers import Concat, ConcatTable, Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          CrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.init import MSRA, Default, Xavier
from bigdl_tpu_torch.nn.linear import Linear, MulConstant
from bigdl_tpu_torch.nn.module import Container, Module, TensorModule
from bigdl_tpu_torch.nn.normalization import (BatchNormalization, LayerNorm,
                                              SpatialBatchNormalization,
                                              SpatialCrossMapLRN)
from bigdl_tpu_torch.nn.pooling import (SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.recurrent import (BiRecurrent, Cell, GRUCell,
                                          LSTMCell, Recurrent, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.reductions import Mean
from bigdl_tpu_torch.nn.shape_ops import Identity, Reshape, View
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = [
    "Abs", "BatchNormalization", "BiRecurrent", "CAddTable", "Cell", "Clamp", "ClassNLLCriterion",
    "Concat", "ConcatTable", "Container", "Criterion",
    "CrossEntropyCriterion", "Default", "Dropout", "ELU", "Exp",
    "GRUCell", "GradientReversal", "HardShrink", "HardTanh", "Identity",
    "LSTMCell", "LayerNorm", "LeakyReLU", "Linear", "Log", "LogSigmoid",
    "LogSoftMax", "MSRA", "Mean", "Module", "MulConstant", "MultiHeadSelfAttention", "PReLU",
    "Power", "RReLU", "ReLU", "ReLU6", "Recurrent", "Reshape", "RnnCell",
    "Sequential", "Sigmoid", "SinusoidalPositionalEncoding", "SoftMax",
    "SoftMin", "SoftPlus", "SoftShrink", "SoftSign",
    "SpatialAveragePooling", "SpatialBatchNormalization",
    "SpatialConvolution", "SpatialCrossMapLRN",
    "SpatialMaxPooling", "Sqrt", "Square", "Tanh", "TanhShrink",
    "TensorModule", "Threshold", "TimeDistributed",
    "TimeDistributedCriterion", "View", "Xavier",
]
