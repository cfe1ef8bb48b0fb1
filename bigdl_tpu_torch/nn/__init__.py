"""Torch-style layers and criterions of the port (counterpart of
bigdl_tpu/nn): every name the JAX package exports, but the JAX ``Context``."""
from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.nn.activations import (
    ELU, Abs, Clamp, Exp, GradientReversal, HardShrink, HardTanh, LeakyReLU,
    Log, LogSigmoid, LogSoftMax, Power, PReLU, ReLU, ReLU6, RReLU, Sigmoid,
    SoftMax, SoftMin, SoftPlus, SoftShrink, SoftSign, Sqrt, Square, Tanh,
    TanhShrink, Threshold)
from bigdl_tpu_torch.nn.attention import (MultiHeadSelfAttention,
                                          SinusoidalPositionalEncoding)
from bigdl_tpu_torch.nn.containers import (Bottle, Concat, ConcatTable,
                                           MapTable, ParallelTable,
                                           Sequential)
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     SpatialConvolutionMap,
                                     SpatialDilatedConvolution,
                                     SpatialFullConvolution,
                                     SpatialShareConvolution)
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, BCECriterion, ClassNLLCriterion, ClassSimplexCriterion,
    CosineEmbeddingCriterion, Criterion, CrossEntropyCriterion,
    DistKLDivCriterion, HingeEmbeddingCriterion, L1Cost,
    L1HingeEmbeddingCriterion, MarginCriterion, MarginRankingCriterion,
    MSECriterion, MultiCriterion, MultiLabelMarginCriterion,
    MultiLabelSoftMarginCriterion, MultiMarginCriterion, ParallelCriterion,
    SmoothL1Criterion, SmoothL1CriterionWithWeights, SoftMarginCriterion,
    SoftmaxWithCriterion, TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout, L1Penalty
from bigdl_tpu_torch.nn.init import (MSRA, BilinearFiller, Default,
                                     InitializationMethod, Xavier)
from bigdl_tpu_torch.nn.linear import (CMul, MM, MV, Add, AddConstant,
                                       Bilinear, CAdd, Cosine, Euclidean,
                                       Linear, LookupTable, Mul, MulConstant)
from bigdl_tpu_torch.nn.module import Container, Module, TensorModule
from bigdl_tpu_torch.nn.moe import MoE
from bigdl_tpu_torch.nn.nms import Nms, nms_indices, nms_mask
from bigdl_tpu_torch.nn.normalization import (
    BatchNormalization, LayerNorm, SpatialBatchNormalization,
    SpatialContrastiveNormalization, SpatialCrossMapLRN,
    SpatialDivisiveNormalization, SpatialSubtractiveNormalization)
from bigdl_tpu_torch.nn.pooling import (RoiPooling, SpatialAveragePooling,
                                        SpatialMaxPooling)
from bigdl_tpu_torch.nn.recurrent import (BiRecurrent, Cell, GRUCell,
                                          LSTMCell, Recurrent, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.nn.reductions import (Index, MaskedSelect, Max, Mean,
                                           Min, Narrow, Select, Sum)
from bigdl_tpu_torch.nn.shape_ops import (Contiguous, Copy, Echo, Identity,
                                          InferReshape, Padding, Replicate,
                                          Reshape, SpatialZeroPadding,
                                          Squeeze, Transpose, Unsqueeze,
                                          View)
from bigdl_tpu_torch.nn.table_ops import (CAddTable, CDivTable, CMaxTable,
                                          CMinTable, CMulTable,
                                          CosineDistance, CriterionTable,
                                          CSubTable, DotProduct,
                                          FlattenTable, JoinTable,
                                          MixtureTable, NarrowTable,
                                          PairwiseDistance, SelectTable)

__all__ = [
    "Abs", "AbsCriterion", "Add", "AddConstant", "BCECriterion",
    "BatchNormalization", "BiRecurrent", "Bilinear", "BilinearFiller",
    "Bottle", "CAdd", "CAddTable", "CDivTable", "CMaxTable", "CMinTable",
    "CMul", "CMulTable", "CSubTable", "Cell", "Clamp", "ClassNLLCriterion",
    "ClassSimplexCriterion", "Concat", "ConcatTable", "Container",
    "Contiguous", "Copy", "Cosine", "CosineDistance",
    "CosineEmbeddingCriterion", "Criterion", "CriterionTable",
    "CrossEntropyCriterion", "Default", "DistKLDivCriterion", "DotProduct",
    "Dropout", "ELU", "Echo", "Euclidean", "Exp", "FlattenTable", "GRUCell",
    "GradientReversal", "HardShrink", "HardTanh", "HingeEmbeddingCriterion",
    "Identity", "Index", "InferReshape", "InitializationMethod",
    "JoinTable", "L1Cost", "L1HingeEmbeddingCriterion", "L1Penalty",
    "LSTMCell", "LayerNorm", "LeakyReLU", "Linear", "Log", "LogSigmoid",
    "LogSoftMax", "LookupTable", "MM", "MSECriterion", "MSRA", "MV",
    "MapTable", "MarginCriterion", "MarginRankingCriterion", "MaskedSelect",
    "Max", "Mean", "Min", "MixtureTable", "MoE", "Module", "Mul", "MulConstant",
    "MultiCriterion", "MultiHeadSelfAttention", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion", "Narrow",
    "NarrowTable", "Nms", "PReLU", "Padding", "PairwiseDistance",
    "ParallelCriterion", "ParallelTable", "Power", "RReLU", "ReLU", "ReLU6",
    "Recurrent", "Replicate", "Reshape", "RnnCell", "RoiPooling", "Select",
    "SelectTable", "Sequential", "Sigmoid", "SinusoidalPositionalEncoding",
    "SmoothL1Criterion", "SmoothL1CriterionWithWeights",
    "SoftMarginCriterion", "SoftMax", "SoftMin", "SoftPlus", "SoftShrink",
    "SoftSign", "SoftmaxWithCriterion", "SpatialAveragePooling",
    "SpatialBatchNormalization", "SpatialContrastiveNormalization",
    "SpatialConvolution", "SpatialConvolutionMap", "SpatialCrossMapLRN",
    "SpatialDilatedConvolution", "SpatialDivisiveNormalization",
    "SpatialFullConvolution", "SpatialMaxPooling",
    "SpatialShareConvolution", "SpatialSubtractiveNormalization",
    "SpatialZeroPadding", "Sqrt", "Square", "Squeeze", "Sum", "Tanh",
    "TanhShrink", "TensorModule", "Threshold", "TimeDistributed",
    "TimeDistributedCriterion", "Transpose", "Unsqueeze", "View", "Xavier",
    "init", "nms_indices", "nms_mask",
]
