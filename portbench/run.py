"""Run one cell of the benchmark of dgsparse_tpu_torch (the PyTorch and
CUDA port) once, on the card this process finds:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
compared for `correct`, each beside its limit. Without a CUDA card, or
with fewer than the cell asks for, it prints no result and exits with a
code other than 0. It reads nothing of `benchmark/` and loads nothing of
JAX or of the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.lib import runner

    return runner.main(args, ROOT, T0)


if __name__ == "__main__":
    sys.exit(main())
