"""neuralsim_torch: the PyTorch/CUDA port of neuralsim_tpu for NVIDIA Hopper.

Module paths and names follow the JAX package, so each part has an obvious
counterpart there. The hot ops are hand-written CUDA kernels (``csrc/``,
built and loaded by :mod:`neuralsim_torch.kernels`); each sits beside a plain
PyTorch version of the same function, which runs for tensors on the CPU.

Entry points: :func:`neuralsim_torch.tools.build.build_renderer` (render),
:func:`neuralsim_torch.tools.build.build_trainer` and
:func:`neuralsim_torch.tools.train.train` (train).
"""
