"""nerfmatch_tpu_torch -- NeRFMatch localization, per-scene NeRF training
and matcher training in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

A port of ``nerfmatch_tpu`` (the JAX reference, which stays beside it).
Module paths mirror the reference:

  nerf      mip-NeRF ops + renderer (eval and train render, resample kernels)
  models    ConvFormer backbone, attention, coarse and c2f matchers
  ops       matching ops; ``ops/kernels`` builds and wraps ``csrc/*.cu``
  eval      localization evaluator, scene-point cache
  pose      host PnP + RANSAC (C++ through ctypes)
  data      NeRF ray and matcher pair datasets, their loader (numpy)
  train     NeRF and matcher trainers, checkpoints, logging, the JAX ->
            torch weights
  utils     pose-error geometry, losses, optimizers and schedules
  config    YAML configs as namespaces
  cli       ``train_nerf``, ``train_nerfmatch``, ``eval_nerf``

The package imports nothing of ``nerfmatch_tpu`` or ``jax``.

Importing the package needs neither ``nvcc`` nor a GPU: kernels build at
their first launch on a CUDA tensor.  CPU tensors run each kernel's plain
PyTorch version.
"""

__version__ = "0.1.0"
