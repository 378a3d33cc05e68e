"""ctypes bindings for the in-repo native host library
(`native/dgsparse_host.cpp`): the CSR transpose and the spconv rulebook
builders.

Counterpart of `dgsparse_tpu/native.py`, with its wrappers `available`,
`csr2csc`, `rulebook_subm` and `rulebook_strided`. The library is built
with g++ and `native/Makefile`'s flags into the port's own build root
(`build/dgsparse_tpu_torch/<hash>/libdgsparse_host.so`, where `<hash>`
covers the source, the flags and the host CPU's feature flags, since
`-march=native` ties the binary to them), at first use and again whenever
the source changes. It never writes under `native/`, whose library the JAX
package builds and loads itself. Every wrapper returns None when the
library did not build or load (no g++), and callers then take their numpy
paths. The TPU plan helpers (`plan_edge_tiles`, `cell_split`) are not
bound: the port has no edge-tile plans and splits cells with stable sorts.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from dgsparse_tpu_torch.utils import metrics

SOURCE = Path(__file__).resolve().parents[1] / "native" / "dgsparse_host.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path() -> Path:
    """Where the library of this source, these flags and this CPU lives."""
    from dgsparse_tpu_torch.kernels._build import BUILD_ROOT

    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_flags())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdgsparse_host.so"


def build() -> Path:
    """Compile the library unless this source's build exists; raises when
    g++ is missing or fails. Writes to a temporary name and renames it into
    place, so concurrent processes never load a half-written file."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native host library of "
                           "dgsparse_tpu_torch is built on first use")
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libdgsparse_host.", suffix=".so",
                               dir=so.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None if it cannot be built or
    loaded."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    with metrics.span("dgsparse.native.load"):
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.dg_csr2csc.argtypes = [_I32P, _I32P, i32, i32, i64, _I32P, _I32P,
                               _I32P]
    lib.dg_rulebook_subm.argtypes = [_I32P, i64, i32, i32, i32, _I32P, i32,
                                     _I32P, _I32P, _I64P]
    lib.dg_rulebook_subm.restype = i64
    lib.dg_rulebook_strided.argtypes = [_I32P, i64, i32, i32, i32, i32, i32,
                                        i32, i32, i32, i32, _I32P, _I32P,
                                        _I32P, _I32P, _I64P]
    lib.dg_rulebook_strided.restype = i64
    lib.dg_version.restype = i32
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def version() -> Optional[int]:
    """The library's `dg_version()`, or None without it."""
    lib = load()
    return None if lib is None else int(lib.dg_version())


def csr2csc(rowptr: np.ndarray, col: np.ndarray, num_rows: int,
            num_cols: int) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
    """(colptr, row, perm) of the CSR transpose, rows ascending within a
    column; None without the library."""
    lib = load()
    if lib is None:
        return None
    nnz = len(col)
    colptr = np.zeros(num_cols + 1, np.int32)
    row = np.empty(nnz, np.int32)
    perm = np.empty(nnz, np.int32)
    lib.dg_csr2csc(np.ascontiguousarray(rowptr, np.int32),
                   np.ascontiguousarray(col, np.int32),
                   num_rows, num_cols, nnz, colptr, row, perm)
    return colptr, row, perm


def _split(imap, omap, knnz, n, k_vol):
    imaps = [imap[kp * n: kp * n + knnz[kp]].copy() for kp in range(k_vol)]
    omaps = [omap[kp * n: kp * n + knnz[kp]].copy() for kp in range(k_vol)]
    return imaps, omaps, [int(x) for x in knnz]


def rulebook_subm(coords: np.ndarray, ks: Tuple[int, int, int],
                  spatial: Tuple[int, int, int], separate_mid: bool):
    """Submanifold rulebook of odd kernels `ks` at padding k // 2:
    (imaps, omaps, knnz) per offset, each offset's pairs by ascending
    output id; None without the library."""
    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, np.int32)
    n = len(coords)
    k_vol = ks[0] * ks[1] * ks[2]
    imap = np.empty(k_vol * n, np.int32)
    omap = np.empty(k_vol * n, np.int32)
    knnz = np.zeros(k_vol, np.int64)
    lib.dg_rulebook_subm(coords, n, ks[0], ks[1], ks[2],
                         np.ascontiguousarray(spatial, np.int32),
                         int(separate_mid), imap, omap, knnz)
    return _split(imap, omap, knnz, n, k_vol)


def rulebook_strided(coords: np.ndarray, ks, st, pad, spatial):
    """Strided rulebook: (out_coords sorted (b, x, y, z), imaps, omaps,
    knnz), each offset's pairs by ascending output id; None without the
    library."""
    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, np.int32)
    n = len(coords)
    k_vol = ks[0] * ks[1] * ks[2]
    out_coords = np.empty((n * k_vol, 4), np.int32)
    imap = np.empty(k_vol * n, np.int32)
    omap = np.empty(k_vol * n, np.int32)
    knnz = np.zeros(k_vol, np.int64)
    num_out = lib.dg_rulebook_strided(
        coords, n, ks[0], ks[1], ks[2], st[0], st[1], st[2],
        pad[0], pad[1], pad[2], np.ascontiguousarray(spatial, np.int32),
        out_coords, imap, omap, knnz)
    return (out_coords[:num_out].copy(),) + _split(imap, omap, knnz, n,
                                                   k_vol)
