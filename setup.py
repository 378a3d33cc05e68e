"""Build script: packages dgsparse_tpu and compiles the native host library.

TPU analog of the reference's setup.py (torch CUDAExtension matrix,
setup.py:26-124): instead of nvcc-compiled torch extensions, the only native
artifact is the host-side planner/rulebook library, built with g++ and
loaded via ctypes (no Python ABI dependency). The device kernels are
JAX/Pallas and need no compilation at install time.
"""

import os
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        so = os.path.join("native", "libdgsparse_host.so")
        try:
            subprocess.run(["make", "-C", "native"], check=True)
        except Exception as e:  # toolchain-less installs still work
            print(f"warning: native library build skipped ({e}); "
                  "numpy fallbacks will be used")
        # Ship the built .so as package data so installed environments
        # (wheel/conda/docker) load it from site-packages — they have no
        # native/ source tree (dgsparse_tpu/native.py probes the package
        # dir when the source is absent).
        if os.path.exists(so):
            shutil.copy2(so, os.path.join("dgsparse_tpu",
                                          "libdgsparse_host.so"))
        super().run()


# dgsparse_tpu_torch ships its CUDA sources: they are compiled with nvcc on
# first use on a CUDA host (dgsparse_tpu_torch/kernels/_build.py).
setup(cmdclass={"build_py": BuildWithNative},
      package_data={"dgsparse_tpu": ["libdgsparse_host.so"],
                    "dgsparse_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]})
