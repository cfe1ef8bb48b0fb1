"""Host data pipeline of the port (counterpart of bigdl_tpu/dataset):
records, datasets, transformers, the prefetch pipeline, image decode and
augmentation, packed shards and Hadoop SequenceFiles, MNIST, CIFAR-10,
text.  numpy only."""
from bigdl_tpu_torch.dataset import cifar, mnist
from bigdl_tpu_torch.dataset.dataset import (DataSet, DistributedDataSet,
                                             LocalArrayDataSet,
                                             LocalDataSet, ShardedDataSet,
                                             TransformedDataSet,
                                             get_batch_size)
from bigdl_tpu_torch.dataset.image import (BGRImgCropper, BytesToBGRImg,
                                           BytesToGreyImg, BytesToImg,
                                           ColorJitter, HFlip, ImgCropper,
                                           ImgNormalizer, ImgPixelNormalizer,
                                           ImgRdmCropper, ImgToBatch,
                                           ImgToImageVector, ImgToSample,
                                           LabeledImage, Lighting,
                                           MTLabeledImgToBatch)
from bigdl_tpu_torch.dataset.prefetch import PipelineRunner
from bigdl_tpu_torch.dataset.sample import (ByteRecord, LabeledSentence,
                                            MiniBatch, Sample)
from bigdl_tpu_torch.dataset.text import (Dictionary,
                                          LabeledSentenceToSample,
                                          SentenceToLabeledSentence,
                                          WordTokenizer)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FuncTransformer, Identity,
                                                 PreFetch, SampleToBatch,
                                                 Transformer)

# the reference's names (ref dataset/image/*.scala): BytesToBGRImg above
# decodes to BGR; the crop, flip and normalisers take per-channel
# constants in the caller's layout, so one class serves BGR, RGB and grey
GreyImgNormalizer = ImgNormalizer
BGRImgNormalizer = ImgNormalizer
BGRImgPixelNormalizer = ImgPixelNormalizer
BGRImgRdmCropper = ImgRdmCropper
GreyImgCropper = ImgRdmCropper  # the reference's grey cropper is random
BGRImgToBatch = ImgToBatch
GreyImgToBatch = ImgToBatch
BGRImgToSample = ImgToSample
BGRImgToImageVector = ImgToImageVector
MTLabeledBGRImgToBatch = MTLabeledImgToBatch
ColoJitter = ColorJitter  # the reference's spelling (ColoJitter.scala)

__all__ = [
    "BGRImgCropper", "BGRImgNormalizer", "BGRImgPixelNormalizer",
    "BGRImgRdmCropper", "BGRImgToBatch", "BGRImgToImageVector",
    "BGRImgToSample", "ByteRecord", "BytesToBGRImg", "BytesToGreyImg",
    "BytesToImg", "ChainedTransformer", "ColoJitter", "ColorJitter",
    "DataSet", "Dictionary", "DistributedDataSet", "FuncTransformer",
    "GreyImgCropper", "GreyImgNormalizer", "GreyImgToBatch", "HFlip",
    "Identity", "ImgCropper", "ImgNormalizer", "ImgPixelNormalizer",
    "ImgRdmCropper", "ImgToBatch", "ImgToImageVector", "ImgToSample",
    "LabeledImage", "LabeledSentence", "LabeledSentenceToSample",
    "Lighting", "LocalArrayDataSet", "LocalDataSet", "MTLabeledBGRImgToBatch",
    "MTLabeledImgToBatch", "MiniBatch", "PipelineRunner", "PreFetch",
    "Sample", "SampleToBatch", "SentenceToLabeledSentence",
    "ShardedDataSet", "TransformedDataSet", "Transformer", "WordTokenizer",
    "cifar", "get_batch_size", "mnist",
]
