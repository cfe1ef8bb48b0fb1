"""ImageNet shard generator (counterpart of
bigdl_tpu/dataset/imagenet_tools.py; ref
models/utils/ImageNetSeqFileGenerator.scala): a class-per-folder image
tree packed into ``.bdts`` shards (``dataset.shardfile``), so that
training streams large files.

  python -m bigdl_tpu_torch.dataset.imagenet_tools -f ./imagenet/train -o ./shards -p 64

The key of a record is its class's 1-based label, or ``"<label>:<file>"``
with ``--hasName`` (``read_shard`` then leaves the label as that text).
"""
from __future__ import annotations

import argparse
import os

from bigdl_tpu_torch.dataset import shardfile


def generate(folder: str, output: str, n_shards: int = 64,
             has_name: bool = False):
    """Pack ``folder``'s images into ``n_shards`` shards under ``output``;
    returns (the shard paths, the class count)."""
    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))

    def records():
        for li, cls in enumerate(classes):
            d = os.path.join(folder, cls)
            for fn in sorted(os.listdir(d)):
                with open(os.path.join(d, fn), "rb") as f:
                    data = f.read()
                key = f"{li + 1}" if not has_name else f"{li + 1}:{fn}"
                yield (key, data)

    paths = shardfile.write_shards(records(), output, n_shards)
    return paths, len(classes)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", "--folder", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-p", "--parallel", type=int, default=64,
                   help="number of shards (the reference's parallel count)")
    p.add_argument("--hasName", action="store_true")
    args = p.parse_args(argv)
    paths, n_classes = generate(args.folder, args.output, args.parallel,
                                args.hasName)
    print(f"wrote {len(paths)} shards for {n_classes} classes to {args.output}")


if __name__ == "__main__":
    main()
