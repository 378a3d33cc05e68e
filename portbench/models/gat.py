"""The program's side of a GAT configuration: the port's adjacency
constructor and its `nn.GAT`, with the benchmark's weights loaded.

The adjacency is `nn.gcn.get_gcn_dcsr_from_edge_index`, as `entry` builds
a GAT's graph: the self-loops added, the CSC view built; the values it
computes are ignored, since attention is structure only. Below the
hybrid gate (average degree 16) the layers take the edge-space branch:
`edge_softmax`, `spmm_multihead`, and `sddmm_csr` in the backward.
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
    out = {}
    for i, conv in ((1, model.gat1), (2, model.gat2)):
        out[f"w{i}"] = (conv.proj.weight, True)
        out[f"a_dst{i}"] = (conv.a_dst, False)
        out[f"a_src{i}"] = (conv.a_src, False)
    return out


def build(cfg: dict, weights: dict, device):
    import torch

    from dgsparse_tpu_torch.nn.gat import GAT

    if cfg["dropout"]:
        raise ValueError("the port's nn.GAT runs here without dropout")
    if cfg["dtype"] != "float32":
        raise ValueError("the port's nn.GAT runs float32 parameters")
    model = GAT(cfg["in_features"], cfg["hidden_features"],
                cfg["num_classes"], cfg["num_heads"]).to(device).eval()
    for conv in (model.gat1, model.gat2):
        if conv.negative_slope != cfg["negative_slope"]:
            raise ValueError(f"the port's GATConv has slope "
                             f"{conv.negative_slope}")
    with torch.no_grad():
        for name, (p, transposed) in param_map(model).items():
            w = weights[name]
            p.copy_(w.t() if transposed else w)
    return model
