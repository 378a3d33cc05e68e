"""Work of a dense product [m, k] x [k, n]: 2 m k n FLOPs (a multiply and
an add each), for the model FLOPs of `mfu.*`."""


def flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n
