"""Host data pipeline of the port (counterpart of bigdl_tpu/dataset):
records, datasets, transformers, MNIST, CIFAR-10, text.  numpy only."""
from bigdl_tpu_torch.dataset import cifar, mnist
from bigdl_tpu_torch.dataset.dataset import (DataSet, DistributedDataSet,
                                             LocalArrayDataSet,
                                             LocalDataSet, ShardedDataSet,
                                             TransformedDataSet,
                                             get_batch_size)
from bigdl_tpu_torch.dataset.image import (HFlip, ImgNormalizer,
                                           ImgRdmCropper, ImgToBatch,
                                           LabeledImage)
from bigdl_tpu_torch.dataset.sample import LabeledSentence, MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FuncTransformer, Identity,
                                                 SampleToBatch, Transformer)

GreyImgNormalizer = ImgNormalizer
GreyImgToBatch = ImgToBatch

__all__ = [
    "ChainedTransformer", "DataSet", "DistributedDataSet", "FuncTransformer",
    "GreyImgNormalizer",
    "GreyImgToBatch",
    "HFlip", "Identity", "ImgNormalizer", "ImgRdmCropper", "ImgToBatch",
    "LabeledImage", "LabeledSentence",
    "LocalArrayDataSet", "LocalDataSet", "MiniBatch", "Sample",
    "SampleToBatch", "ShardedDataSet", "TransformedDataSet", "Transformer",
    "cifar", "get_batch_size", "mnist",
]
