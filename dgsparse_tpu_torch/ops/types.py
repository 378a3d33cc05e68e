"""Op enums: reduction, semiring compute, and algorithm selection.

Counterpart of `dgsparse_tpu/ops/types.py`, with the same names and values
so code and tests can pass either package's enum by value. For SUM/MEAN
`spmm` on a storage with a hybrid plan (`core/planner.py::HybridPlan`),
AUTO and PALLAS_ROW_TILE run the hybrid tiers (`ops/hybrid.py`: the
dense-cell, BELL and CSR kernels), as the JAX package's AUTO does on the
TPU; every other case, and XLA_SEGMENT, PALLAS_EDGE_TILE and PALLAS_BELL
always, run the CSR kernels (`kernels/spmm_csr.py`, `spmm_maxmin.py`).
AUTO first takes a route the tuner measured for the graph on this card
(`utils/tune.py`), and otherwise follows the JAX gate.
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
