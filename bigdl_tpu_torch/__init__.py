"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu`` for NVIDIA Hopper.

The layout mirrors ``bigdl_tpu/`` so every module has a counterpart of the
same name (``nn/``, ``models/``, ``dataset/``, ``optim/``, ``ops/``,
``serve/``).  The
port imports ``torch`` and never ``jax`` or ``bigdl_tpu``; the TPU kernels
of the JAX package become kernels written by hand for ``sm_90a`` under
``csrc/``, each beside a plain PyTorch version of the same function.

Importing this package does not import its submodules: pull in what you
use (``bigdl_tpu_torch.serve.decode``, ``bigdl_tpu_torch.ops``, ...).
"""
