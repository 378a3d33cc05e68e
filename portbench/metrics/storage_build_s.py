"""`storage_build_s`: host seconds of the port's constructor of the
adjacency from the raw edge list (`models/<model>.py::adjacency`: the
GCN normalisation on the host, the CSC view's sort on the card), ended by
a synchronize."""


def read(ctx):
    return ctx.storage_build_s
