"""Op enums: reduction, semiring compute, and algorithm selection.

Counterpart of `dgsparse_tpu/ops/types.py`, with the same names and values
so code and tests can pass either package's enum by value. On CUDA every
`Algorithm` runs the one CSR kernel (`kernels/spmm_csr.py`); the value is
accepted for API parity. AUTO selection among GPU schedules comes when
there is more than one.
"""

import enum


class ReduceOp(enum.Enum):
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


class ComputeOp(enum.Enum):
    """Semiring combine `compute(edge_val, node_feat)`: SUB is
    ``feat - edge`` and DIV is ``feat / edge``."""

    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"


class Algorithm(enum.IntEnum):
    """Kernel schedule selector (values of the JAX package's enum)."""

    AUTO = -1
    XLA_SEGMENT = 0
    PALLAS_ROW_TILE = 1
    PALLAS_EDGE_TILE = 2
    PALLAS_BELL = 3


def as_algorithm(algorithm) -> Algorithm:
    if isinstance(algorithm, Algorithm):
        return algorithm
    return Algorithm(int(algorithm))


def as_reduce(op) -> ReduceOp:
    if isinstance(op, ReduceOp):
        return op
    return ReduceOp(str(op).lower())


def as_compute(op) -> ComputeOp:
    if isinstance(op, ComputeOp):
        return op
    return ComputeOp(str(op).lower())
