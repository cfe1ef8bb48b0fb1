"""Models of the port (counterpart of bigdl_tpu/models)."""
from bigdl_tpu_torch.models.inception import (Inception_v1,
                                              Inception_v1_NoAuxClassifier,
                                              inception_module)
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.rnn import BiLSTMClassifier, SimpleRNN, generate
from bigdl_tpu_torch.models.textclassifier import (TextClassifierBiLSTM,
                                                   TextClassifierConv)
from bigdl_tpu_torch.models.transformer import TransformerLM

__all__ = ["BiLSTMClassifier", "Inception_v1", "Inception_v1_NoAuxClassifier",
           "LeNet5", "SimpleRNN", "TextClassifierBiLSTM",
           "TextClassifierConv", "TransformerLM", "generate",
           "inception_module"]
