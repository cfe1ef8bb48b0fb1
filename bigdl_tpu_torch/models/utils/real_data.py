"""Real-data train + evaluate loop over an image class-folder
(counterpart of bigdl_tpu/models/utils/real_data.py).

The role of the reference's per-model ``Test`` mains and
``example/loadmodel/ModelValidator.scala:114-146``: decode REAL image
files through the pipeline, train a small conv net on the device, and
report top-1/top-5 through the validation loop, on any class-per-subfolder
image directory.  The JAX helper borrows the process-wide random stream
(``RNG.scoped()``); here the records' shuffles draw from the dataset's own
stream (``DataSet.array(records, seed)``), the weights from
``generator(seed)``, and the dropout stream is left alone (the net has no
dropout).
"""
from __future__ import annotations


def small_convnet(n_classes: int, image_size: int, device="cuda",
                  generator=None):
    """Conv-pool-conv-pool-linear classifier, LeNet-scale (the smallest
    member of the reference's conv zoo, models/lenet/LeNet5.scala)."""
    from bigdl_tpu_torch import nn

    kw = dict(device=device, generator=generator)
    after_pool = image_size // 4
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1, **kw))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    m.add(nn.SpatialConvolution(8, 16, 3, 3, 1, 1, 1, 1, **kw))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    m.add(nn.Reshape([16 * after_pool * after_pool]))
    m.add(nn.Linear(16 * after_pool * after_pool, n_classes, **kw))
    m.add(nn.LogSoftMax())
    return m


def _byte_record_dataset(folder: str, image_size: int, seed: int):
    """ImageFolder paths -> decoded/normalized dataset + records + class
    count."""
    from bigdl_tpu_torch.dataset.dataset import DataSet
    from bigdl_tpu_torch.dataset.image import BytesToImg, ImgNormalizer
    from bigdl_tpu_torch.dataset.sample import ByteRecord

    paths = list(DataSet.image_folder(folder).data(train=False))
    kept = [(p, lab) for p, lab in paths
            if p.lower().endswith((".png", ".jpeg", ".jpg", ".bmp"))]
    if not kept:
        raise ValueError(f"no decodable images under {folder}")
    # re-densify labels: filtering can empty a class folder, and a gap in
    # the 1-based label range would put a target past the last class
    remap = {lab: float(i + 1)
             for i, lab in enumerate(sorted({lab for _, lab in kept}))}
    recs = []
    for path, label in kept:
        with open(path, "rb") as f:
            recs.append(ByteRecord(f.read(), remap[label]))
    ds = (DataSet.array(recs, seed)
          >> BytesToImg(scale_to=image_size)
          >> ImgNormalizer(125.0, 62.0))
    return ds, recs, len(remap)


def train_and_eval_image_folder(folder: str, image_size: int = 32,
                                iterations: int = 120,
                                learning_rate: float = 0.05,
                                seed: int = 5, model=None, device="cuda"):
    """Decode -> train -> validate on one image class-folder, every
    record in one batch (a tiny-dataset overfit drill: a healthy decode
    and label path gives top1 near 1.0, broken label plumbing chance).

    Returns ``{"top1", "top5", "n_records", "n_classes", "loss",
    "iterations"}``, top1/top5 from ``validate`` (ref Validator.scala:24)
    over the records the model trained on."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.image import ImgToBatch
    from bigdl_tpu_torch.optim import (LocalOptimizer, Top1Accuracy,
                                       Top5Accuracy, max_iteration, validate)
    from bigdl_tpu_torch.utils.random import generator
    from bigdl_tpu_torch.utils.table import T

    ds, recs, n_classes = _byte_record_dataset(folder, image_size, seed)
    if model is None:
        model = small_convnet(n_classes, image_size, device=device,
                              generator=generator(seed))
    batched = ds >> ImgToBatch(len(recs))
    opt = LocalOptimizer(model, batched, nn.ClassNLLCriterion(),
                         device=device)
    opt.set_state(T(learningRate=learning_rate, momentum=0.9))
    opt.set_end_when(max_iteration(iterations))
    opt.optimize()
    (_, top1), (_, top5) = validate(model, batched,
                                    [Top1Accuracy(), Top5Accuracy()], device)
    return {"top1": round(top1.result()[0], 4),
            "top5": round(top5.result()[0], 4),
            "n_records": len(recs), "n_classes": n_classes,
            "loss": round(float(opt.state["loss"]), 6),
            "iterations": iterations}
