"""nerfmatch_tpu_torch -- NeRFMatch localization and per-scene NeRF
training in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

A port of ``nerfmatch_tpu`` (the JAX reference, which stays beside it).
Module paths mirror the reference:

  nerf      mip-NeRF ops + renderer (eval and train render, resample kernels)
  models    ConvFormer backbone, attention, coarse and c2f matchers
  ops       matching ops; ``ops/kernels`` builds and wraps ``csrc/*.cu``
  eval      localization evaluator (PnP through ``nerfmatch_tpu.pose``)
  data      NeRF ray dataset and its loader (numpy)
  train     NeRF trainer, checkpoints, logging, the JAX -> torch weights
  utils     pose-error geometry, NeRF losses, optimizers and schedules
  cli       ``train_nerf``

Importing the package needs neither ``nvcc`` nor a GPU: kernels build at
their first launch on a CUDA tensor.  CPU tensors run each kernel's plain
PyTorch version.
"""

__version__ = "0.1.0"
