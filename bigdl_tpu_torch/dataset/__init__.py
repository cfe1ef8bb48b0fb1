"""Host data pipeline of the port (counterpart of bigdl_tpu/dataset):
records, datasets, transformers, MNIST, text.  numpy only."""
from bigdl_tpu_torch.dataset.dataset import (DataSet, LocalArrayDataSet,
                                             LocalDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.image import (HFlip, ImgNormalizer,
                                           ImgRdmCropper, ImgToBatch,
                                           LabeledImage)
from bigdl_tpu_torch.dataset.sample import LabeledSentence, MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 Identity, SampleToBatch,
                                                 Transformer)

GreyImgNormalizer = ImgNormalizer
GreyImgToBatch = ImgToBatch

__all__ = [
    "ChainedTransformer", "DataSet", "GreyImgNormalizer", "GreyImgToBatch",
    "HFlip", "Identity", "ImgNormalizer", "ImgRdmCropper", "ImgToBatch",
    "LabeledImage", "LabeledSentence",
    "LocalArrayDataSet", "LocalDataSet", "MiniBatch", "Sample",
    "SampleToBatch", "TransformedDataSet", "Transformer",
]
