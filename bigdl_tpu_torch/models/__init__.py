"""Models of the port (counterpart of bigdl_tpu/models)."""
from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNet_OWT
from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.inception import (Inception_v1,
                                              Inception_v1_NoAuxClassifier,
                                              Inception_v2, inception_module,
                                              inception_v2_module)
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import (ResNet, ResNetCifar, basic_block,
                                           bottleneck)
from bigdl_tpu_torch.models.rnn import BiLSTMClassifier, SimpleRNN, generate
from bigdl_tpu_torch.models.textclassifier import (TextClassifierBiLSTM,
                                                   TextClassifierConv)
from bigdl_tpu_torch.models.transformer import (TransformerClassifier,
                                                TransformerLM)
from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["AlexNet", "AlexNet_OWT", "Autoencoder", "BiLSTMClassifier",
           "Inception_v1", "Inception_v1_NoAuxClassifier", "Inception_v2",
           "LeNet5", "ResNet", "ResNetCifar", "SimpleRNN",
           "TextClassifierBiLSTM", "TextClassifierConv",
           "TransformerClassifier", "TransformerLM",
           "Vgg_16", "Vgg_19", "VggForCifar10", "basic_block", "bottleneck",
           "generate",
           "inception_module", "inception_v2_module"]
