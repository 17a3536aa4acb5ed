"""Host seconds inside ``Graph.write`` (``graph.graph``), mean over the
calls."""

from benchmark.metrics._shared import span_s

SPANS = [{"name": "graph_write", "kind": "call",
          "target": "gossamer_tpu_torch.graph.graph:Graph.write"}]


def read(records):
    return span_s(records, "graph_write")
