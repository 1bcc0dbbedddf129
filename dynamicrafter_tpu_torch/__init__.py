"""DynamiCrafter image-to-video inference in PyTorch for one NVIDIA H100.

A port of the JAX package `dynamicrafter_tpu`, which stays the numerical
reference. Plain tensor code is PyTorch; the two attention kernels on the
320x512 path are CUDA C++ for sm_90a (`csrc/`), built at first use and
bound with ctypes. Module names mirror the JAX package; `state_dict` keys
are the released reference checkpoint keys.

Nothing here imports JAX.
"""

__version__ = "0.1.0"
