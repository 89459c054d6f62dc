"""custrings_tpu_torch — the PyTorch + CUDA port of custrings_tpu.

Strings live as Arrow-style torch tensors (bytes + offsets + validity) on
one device.  Plain tensor work is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a CUDA kernel written by hand for Hopper
(`csrc/*.cu`), built with nvcc at first use on a CUDA tensor.  CPU tensors
take each kernel's plain PyTorch version.  This package imports neither
JAX nor `custrings_tpu`.

Public modules:
    custrings_tpu_torch.nvstrings   to_device / contains / replace / to_host
    custrings_tpu_torch.nvcategory  from_strings / keys / values
"""

from .column import StringColumn  # noqa: F401

__version__ = "0.1.0"
