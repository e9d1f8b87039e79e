"""Kernels of the port.  Each CUDA source in ``csrc/`` is built with nvcc
at first use (``build.py``); nothing is compiled or loaded at import."""
from repro_torch.kernels import (build, flash_attention, fused_lora, ops,
                                 ragged, ref)
