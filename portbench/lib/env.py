"""The run's surroundings: cache directories, the tuner's cache, the
program's import from the checkout, the card's description, and the look
for JAX in the process.

Every cache a run can fill sits at a fixed path: the kernels' `.so` files
in the port's own `build/dgsparse_tpu_torch/` inside the checkout, the
extension and Triton caches under `build/portbench/` beside it, and the
route tuner's cache (`DGSPARSE_TUNE_CACHE`) in an empty file under the
run's `TMPDIR`, so AUTO's route never depends on a file an earlier run
left behind.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List

# top-level module names no run may load: JAX, its companions, and the
# JAX package the port was made from (compared whole: the port's own
# name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "dgsparse_tpu")
PROGRAM = "dgsparse_tpu_torch"


def prepare(root: Path) -> None:
    """Set the cache directories and an empty tuner cache, before torch
    or the program is imported."""
    build = Path(root) / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(build / sub)
    tune = Path(tempfile.gettempdir()) / "portbench" / "tune.json"
    tune.parent.mkdir(parents=True, exist_ok=True)
    tune.write_text("")
    os.environ["DGSPARSE_TUNE_CACHE"] = str(tune)


def import_program(root: Path):
    """The port's package, which has to be the checkout's own: a run in a
    directory without it fails rather than find another copy."""
    root = Path(root).resolve()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import dgsparse_tpu_torch

    where = Path(dgsparse_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise ImportError(f"{PROGRAM} was found at {where}, outside the "
                          f"checkout {root}")
    return dgsparse_tpu_torch


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card(torch, chips: int) -> dict:
    """The result's `device`: the card's name and count, with the power
    limit and SM clocks that `nvidia-smi` reads beside it."""
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0",
             "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        limit, sm, sm_max = (v.strip() for v in out.splitlines()[0].split(","))
        dev.update(power_limit_w=float(limit), sm_clock_mhz=float(sm),
                   sm_clock_max_mhz=float(sm_max))
    except (OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:
        print(f"nvidia-smi gave nothing: {e}", file=sys.stderr)
    return dev
