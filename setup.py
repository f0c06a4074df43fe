"""Package setup (reference setup.py equivalent): ships configs and any
pretrained artifact dirs as package data."""

from setuptools import find_packages, setup

setup(
    name="blind_image_denoising_tpu",
    version="0.2.0",
    description="TPU-native JAX framework for blind image denoising "
                "with bias-free CNNs",
    license="MIT",
    python_requires=">=3.10",
    packages=find_packages(exclude=("tests", "tests.*")),
    package_data={
        "blind_image_denoising_tpu": [
            "configs/*.json",
            "pretrained/*/*",
            "images/*.png",
            "images/*.jpg",
            "data/native/*.cc",
        ],
        # the PyTorch/CUDA port: kernel sources, built with nvcc at first use
        "blind_image_denoising_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pillow",
    ],
    entry_points={
        "console_scripts": [
            "bid-tpu-train=blind_image_denoising_tpu.train:main",
            "bid-tpu-export=blind_image_denoising_tpu.export:main",
            "bid-tpu-build=blind_image_denoising_tpu.build:main",
            "bid-tpu-analyze=blind_image_denoising_tpu.analyze:main",
        ],
    },
)
