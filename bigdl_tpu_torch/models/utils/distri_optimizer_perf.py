"""Data-parallel synthetic-data throughput CLI (counterpart of
bigdl_tpu/models/utils/distri_optimizer_perf.py; ref
models/utils/DistriOptimizerPerf.scala:41-138): each rank of the world
(torchrun's variables, else a world of one) takes its share of the batch.

  torchrun --nproc-per-node 4 -m bigdl_tpu_torch.models.utils.distri_optimizer_perf --model inception_v1 -b 128
"""
from bigdl_tpu_torch.models.utils.perf import main as _main


def main(argv=None):
    return _main(argv, force_distributed=True)


if __name__ == "__main__":
    main()
