"""Install pixsfm_tpu (pure Python + optional native graph core).

The reference drives a CMake build from setup.py (reference: setup.py:19-103);
here the only native piece is the ctypes graph core, compiled with g++ if
available (the package works without it via the numpy fallback).
"""

import subprocess
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        script = Path(__file__).parent / "pixsfm_tpu" / "native" / "build.sh"
        try:
            subprocess.run(["sh", str(script)], check=True)
        except (OSError, subprocess.CalledProcessError):
            print("WARNING: native graph core build failed; "
                  "using numpy fallback")
        super().run()


setup(
    name="pixsfm_tpu",
    version="0.1.0",
    description="TPU-native featuremetric Structure-from-Motion refinement",
    packages=find_packages(include=["pixsfm_tpu", "pixsfm_tpu.*",
                                    "pixsfm_tpu_torch",
                                    "pixsfm_tpu_torch.*"]),
    package_data={
        "pixsfm_tpu": ["configs/*.yaml", "native/*.so", "native/*.cpp",
                       "native/build.sh"],
        # the PyTorch/CUDA port: kernels are built from these sources with
        # nvcc at first use, the native graph core with g++
        "pixsfm_tpu_torch": ["configs/*.yaml", "kernels/csrc/*.cu",
                             "kernels/csrc/*.h", "native/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "numpy", "h5py", "pyyaml", "pillow", "scipy",
    ],
    cmdclass={"build_py": BuildWithNative},
    entry_points={
        "console_scripts": [
            "pixsfm-refine-hloc=pixsfm_tpu.refine_hloc:main",
            "pixsfm-refine-colmap=pixsfm_tpu.refine_colmap:main",
            "pixsfm-localize=pixsfm_tpu.localize:main",
        ],
    },
)
