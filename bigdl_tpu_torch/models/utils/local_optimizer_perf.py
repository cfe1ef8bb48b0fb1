"""Single-host synthetic-data throughput CLI (counterpart of
bigdl_tpu/models/utils/local_optimizer_perf.py; ref
models/utils/LocalOptimizerPerf.scala).

  python -m bigdl_tpu_torch.models.utils.local_optimizer_perf --model vgg16 -b 128
"""
from bigdl_tpu_torch.models.utils.perf import main as _main


def main(argv=None):
    return _main(argv, force_distributed=False)


if __name__ == "__main__":
    main()
