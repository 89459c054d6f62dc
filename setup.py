"""Packaging for custrings_tpu and its PyTorch/CUDA port custrings_tpu_torch
(reference: python/setup.py ships prebuilt shims; here the native pieces
build themselves at first use — custrings_tpu/native/build.py with the
system compiler, custrings_tpu_torch/kernels.py with nvcc from csrc/*.cu)."""

from setuptools import find_packages, setup

setup(
    name="custrings-tpu",
    version="0.1.0",
    description="TPU-native columnar string engine (cuStrings capabilities), "
    "with a PyTorch/CUDA port",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "custrings_tpu.native": ["*.c"],
        "custrings_tpu_torch": ["csrc/*.cu", "csrc/*.c"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"torch": ["torch"]},
)
