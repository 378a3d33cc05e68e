"""Plain PyTorch pieces the model references share: products at a stated
precision, edge-space aggregation, the GCN normalisation, cross-entropy
and Adam written out.

It imports torch alone: nothing of the program, nothing of JAX. Every
product runs with TF32 off, at the precision `prec` names:
- "fp32": float32 operands as they are;
- "tf32": the control's precision, one step below float32 with TF32 off:
  each operand of a product rounded to TF32 (10 mantissa bits, to
  nearest), the products and sums then taken in float32, as TF32 tensor
  cores take them. Rounding the operands here makes the control the same
  on the card and on the CPU.
"""

import torch

PRECISIONS = ("fp32", "tf32")


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    # round to nearest, ties to even, on the 13 bits TF32 drops
    keep = (bits >> 13) & 1
    return ((bits + 0xFFF + keep) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    """Rounds to TF32 going forward, and the gradient coming back, as the
    backward's products would take it."""

    @staticmethod
    def forward(ctx, t):
        return _round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def to_prec(t: torch.Tensor, prec: str) -> torch.Tensor:
    """t with its float32 mantissa rounded to `prec`."""
    if prec == "fp32":
        return t
    if prec != "tf32":
        raise ValueError(f"precision {prec!r} is not one of {PRECISIONS}")
    return _TF32.apply(t)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return to_prec(a, prec) @ to_prec(b, prec)


def with_self_loops(edge_index: torch.Tensor, n: int) -> torch.Tensor:
    loops = torch.arange(n, device=edge_index.device, dtype=edge_index.dtype)
    return torch.cat([edge_index, torch.stack([loops, loops])], 1)


def gcn_values(edge_index: torch.Tensor, n: int) -> torch.Tensor:
    """D^-1/2 (A + I) D^-1/2's value on each edge of `edge_index` (self-
    loops already in it), the degree counting each row's entries."""
    row, col = edge_index[0], edge_index[1]
    deg = torch.bincount(row, minlength=n).to(torch.float64)
    dinv = deg.clamp(min=1).rsqrt()
    return (dinv[row] * dinv[col]).to(torch.float32)


def aggregate(edge_index: torch.Tensor, vals: torch.Tensor,
              h: torch.Tensor, n: int, prec: str) -> torch.Tensor:
    """out[r] = sum over edges (r, c) of vals[e] * h[c]: vals [E] or
    [E, H] for h [N, F] or [N, H, F]."""
    row, col = edge_index[0], edge_index[1]
    v = to_prec(vals, prec)
    msg = to_prec(h, prec).index_select(0, col)
    msg = msg * v.reshape(v.shape + (1,) * (msg.dim() - v.dim()))
    return msg.new_zeros((n,) + tuple(h.shape[1:])).index_add(0, row, msg)


def edge_softmax(edge_index: torch.Tensor, e: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Softmax of per-edge scores e [E, H] over each row's edges."""
    row = edge_index[0]
    idx = row.unsqueeze(1).expand_as(e)
    top = e.new_full((n, e.shape[1]), float("-inf")).scatter_reduce(
        0, idx, e.detach(), "amax")
    ex = torch.exp(e - top.index_select(0, row))
    den = ex.new_zeros((n, e.shape[1])).index_add(0, row, ex)
    return ex / den.index_select(0, row)


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over nodes of -log softmax(logits)[y]."""
    logp = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    return -logp.gather(1, y.unsqueeze(1)).mean()


class Adam:
    """Adam (Kingma and Ba, 2015) with bias correction, eps outside the
    square root, written out."""

    def __init__(self, params: dict, lr: float, betas, eps: float):
        self.params = params
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            den = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.sub_(self.lr * (self.m[k] / c1) / den)


def train(model, cfg: dict, graph: dict, x, y, weights: dict, steps: int,
          prec: str, loss_rows=None) -> dict:
    """`steps` full-graph Adam steps of a reference `model` module from
    `weights`: each step's loss before its update, the first step's
    gradients, and the weights after the last step. `loss_rows` (a fault
    for the control's test) takes the loss over those nodes only."""
    opt = cfg["optimizer"]
    params = {k: v.detach().clone() for k, v in weights.items()}
    adam = Adam(params, opt["lr"], tuple(opt["betas"]), opt["eps"])
    ctx = model.prepare(cfg, graph, x.device)
    losses, first = [], None
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        logits = model.forward(cfg, ctx, x, leaves, prec)
        if loss_rows is not None:
            loss = cross_entropy(logits[loss_rows], y[loss_rows])
        else:
            loss = cross_entropy(logits, y)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(grads)
    return {"losses": losses, "grads": first, "params": params}
