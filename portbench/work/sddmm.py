"""Work of an SDDMM over nnz edges of rows f wide (per edge, the dot
product of two f-vectors): 2 nnz f FLOPs, for the model FLOPs of
`mfu.*`."""


def flops(nnz: int, f: int) -> float:
    return 2.0 * nnz * f
