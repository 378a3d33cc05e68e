"""Build `csrc/*.cu` with nvcc on first use and load the result with ctypes.

Each source becomes a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), written to
`build/dgsparse_tpu_torch/<hash>/lib<name>.so` beside the package, where
`<hash>` covers the sources and the flags. A build writes to a temporary
name and renames it into place, so concurrent processes never load a
half-written file. There is no fallback: a missing nvcc or a failed build
raises.
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "dgsparse_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED = {}


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    log: str            # nvcc's output, with the -Xptxas -v resource lines
    seconds: float      # 0.0 when the library was already built
    cached: bool


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels of "
        "dgsparse_tpu_torch are built from csrc/ on first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile `csrc/<name>.cu` for sm_90a unless the library exists."""
    out_dir = BUILD_ROOT / _digest(name)
    so = out_dir / f"lib{name}.so"
    log = out_dir / f"lib{name}.log"
    if so.exists():
        return Built(so, log.read_text() if log.exists() else "", 0.0, True)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so",
                               dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        seconds = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        log.write_text(text)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Built(so, text, seconds, False)


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return _LOADED[name]
