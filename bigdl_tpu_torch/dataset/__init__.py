"""Host data pipeline of the port (counterpart of bigdl_tpu/dataset):
records, datasets, transformers, the prefetch pipeline, MNIST, CIFAR-10,
text.  numpy only."""
from bigdl_tpu_torch.dataset import cifar, mnist
from bigdl_tpu_torch.dataset.dataset import (DataSet, DistributedDataSet,
                                             LocalArrayDataSet,
                                             LocalDataSet, ShardedDataSet,
                                             TransformedDataSet,
                                             get_batch_size)
from bigdl_tpu_torch.dataset.image import (HFlip, ImgNormalizer,
                                           ImgRdmCropper, ImgToBatch,
                                           LabeledImage)
from bigdl_tpu_torch.dataset.prefetch import PipelineRunner
from bigdl_tpu_torch.dataset.sample import LabeledSentence, MiniBatch, Sample
from bigdl_tpu_torch.dataset.text import (Dictionary,
                                          LabeledSentenceToSample,
                                          SentenceToLabeledSentence,
                                          WordTokenizer)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FuncTransformer, Identity,
                                                 PreFetch, SampleToBatch,
                                                 Transformer)

GreyImgNormalizer = ImgNormalizer
GreyImgToBatch = ImgToBatch

__all__ = [
    "ChainedTransformer", "DataSet", "Dictionary", "DistributedDataSet",
    "FuncTransformer", "GreyImgNormalizer",
    "GreyImgToBatch",
    "HFlip", "Identity", "ImgNormalizer", "ImgRdmCropper", "ImgToBatch",
    "LabeledImage", "LabeledSentence", "LabeledSentenceToSample",
    "LocalArrayDataSet", "LocalDataSet", "MiniBatch", "PipelineRunner",
    "PreFetch", "Sample", "SampleToBatch", "SentenceToLabeledSentence",
    "ShardedDataSet", "TransformedDataSet", "Transformer", "WordTokenizer",
    "cifar", "get_batch_size", "mnist",
]
