"""Row-degree statistics of a CSR structure (counterpart of
`dgsparse_tpu/utils/stats.py`; the reference's calc_vari,
src/util/cuda_util.cuh:98)."""

from typing import Dict

import numpy as np

from dgsparse_tpu_torch.core.formats import _host


def degree_stats(rowptr) -> Dict[str, float]:
    """Mean, variance and max of the row degrees, the empty rows and the
    imbalance (max / mean), from a rowptr tensor or array."""
    rowptr = _host(rowptr)
    deg = np.diff(rowptr).astype(np.float64)
    mean = float(deg.mean()) if len(deg) else 0.0
    return {
        "num_rows": int(len(deg)),
        "nnz": int(rowptr[-1]) if len(rowptr) else 0,
        "mean_degree": mean,
        "degree_variance": float(deg.var()) if len(deg) else 0.0,
        "max_degree": float(deg.max()) if len(deg) else 0.0,
        "empty_rows": int((deg == 0).sum()),
        "imbalance": float(deg.max() / mean) if mean else 0.0,
    }
