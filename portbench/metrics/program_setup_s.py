"""`program_setup_s`: host seconds of the program's outermost set-up spans
before the traced window (`lib/spans.py::setup_spans`: storage
construction, the adjacency's normalisation, kernel and native library
loads, the optimizer, rulebooks): the part of `setup_s` the program
itself spends. Nothing without the program's set-up spans."""

from portbench.lib import spans


def read(ctx):
    records = getattr(ctx, "setup_spans", None)
    if not records:
        return None
    return sum(r["end_ns"] - r["start_ns"]
               for r in spans.setup_spans(records)) * 1e-9
