"""The numbers that decide `correct`, each the gap between what the timed
path produced and what the plain reference works out from the same raw
inputs.

Serving: `logits_gap`, the largest |program - reference| over the sampled
requests' logits, over the largest |reference| logit.

Training, over the first three steps of the object the window then runs:
- `loss_gap`: the largest |program - reference| / |reference| of a
  step's loss;
- `grad_gap`: over leaves, the largest |‖g‖ - ‖g_ref‖| of the first
  gradient (the program's as Adam holds it after step 1), over the larger
  of the reference leaf's norm and the median leaf's;
- `update_gap`: the same for the change of the parameters over the three
  steps, every leaf;
- `grad_gap_median`, `update_gap_median`: the median leaf's gap, where
  one small leaf's round-off swings the worst (a GAT's a_dst, whose
  gradient the softmax all but cancels). A cell compares the numbers its
  limits file names.
"""

from typing import Dict, List

import torch

def logits_gap(outs: List[torch.Tensor], ref: torch.Tensor) -> float:
    scale = float(ref.abs().max())
    gap = max(float((o.to(ref.device) - ref).abs().max()) for o in outs)
    return gap / scale


def _median(xs: List[float]) -> float:
    return float(torch.tensor(xs, dtype=torch.float64).median())


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> List[float]:
    """Per leaf, |‖got‖ - ‖ref‖| over the larger of the leaf's reference
    norm and the median leaf's."""
    floor = _median([ref[k] for k in ref])
    return [abs(got[k] - ref[k]) / max(ref[k], floor) for k in leaves]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def train_gaps(prog: dict, ref: dict, weights: dict) -> Dict[str, float]:
    """prog: {"losses": [3], "grad_norms", "update_norms"} of the program;
    ref: `reference.common.train`'s result from `weights`."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    g_ref = norms(ref["grads"])
    u_ref = norms({k: ref["params"][k] - weights[k] for k in weights})
    grads = leaf_gaps(prog["grad_norms"], g_ref, list(g_ref))
    updates = leaf_gaps(prog["update_norms"], u_ref, list(u_ref))
    return {"loss_gap": max(losses),
            "grad_gap": max(grads), "grad_gap_median": _median(grads),
            "update_gap": max(updates),
            "update_gap_median": _median(updates)}
