"""nerfmatch_tpu_torch -- the NeRFMatch localization path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``nerfmatch_tpu`` (the JAX reference, which stays beside it).
Module paths mirror the reference:

  nerf      mip-NeRF ops + eval renderer (fused render / resample kernels)
  models    ConvFormer backbone, attention, coarse and c2f matchers
  ops       matching ops; ``ops/kernels`` builds and wraps ``csrc/*.cu``
  eval      localization evaluator (PnP through ``nerfmatch_tpu.pose``)
  utils     pose-error geometry
  train     the JAX -> torch weight bridge

Importing the package needs neither ``nvcc`` nor a GPU: kernels build at
their first launch on a CUDA tensor.  CPU tensors run each kernel's plain
PyTorch version.
"""

__version__ = "0.1.0"
