"""PyTorch + CUDA port of multimodalvc_tpu for NVIDIA Hopper.

The JAX package ``multimodalvc_tpu`` is the reference.  This package mirrors
its layout (``nn/``, ``ops/``, ``models/``, ``interop/``, ``runtime/``,
``config/``, ``criterions/``, ``parallel/``, ``utils/``, ``tasks.py``), serves
the AVSR beam-search path and trains the AVSR model (the LM loss with LoRA,
the masked optimizers, checkpoints), on one GPU or several (``parallel/``: one process
a GPU); the Pallas kernels on those paths are hand-written
CUDA kernels under ``csrc/``, built by nvcc at first use
(``ops/kernel_lib.py``).
"""
