"""The program's side of a GCN configuration: the port's adjacency
constructor and its `nn.GCN`, with the benchmark's weights loaded.

The adjacency is `nn.gcn.get_gcn_dcsr_from_edge_index`, which adds the
self-loops, normalises on the host and builds the CSC view (its sort on
the card): what a user of the port calls on a raw edge list. The model is
the port's 2-layer `nn.GCN` in eval mode (no dropout), as `entry` builds
it.
"""


def adjacency(cfg: dict, graph: dict, device):
    from dgsparse_tpu_torch.nn.gcn import get_gcn_dcsr_from_edge_index

    return get_gcn_dcsr_from_edge_index(graph["edge_index"],
                                        graph["num_nodes"], device=device)


def nnz(adj) -> int:
    """Stored entries of the adjacency, the self-loops included."""
    return adj.nnz


def param_map(model) -> dict:
    """{reference name: (the program's parameter, stored transposed)}."""
    return {"w1": (model.conv1.linear.weight, True),
            "b1": (model.conv1.linear.bias, False),
            "w2": (model.conv2.linear.weight, True),
            "b2": (model.conv2.linear.bias, False)}


def build(cfg: dict, weights: dict, device):
    import torch

    from dgsparse_tpu_torch.nn.gcn import GCN

    if cfg["num_layers"] != 2 or cfg["dropout"] or cfg["batch_norm"]:
        raise ValueError("the port's nn.GCN has 2 layers, no BatchNorm, and "
                         "runs here without dropout")
    if cfg["dtype"] != "float32":
        raise ValueError("the port's nn.GCN runs float32 parameters")
    model = GCN(cfg["in_features"], cfg["hidden_features"],
                cfg["num_classes"]).to(device).eval()
    with torch.no_grad():
        for name, (p, transposed) in param_map(model).items():
            w = weights[name]
            p.copy_(w.t() if transposed else w)
    return model
