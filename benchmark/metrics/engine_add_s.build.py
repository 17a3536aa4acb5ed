"""The engine's add loop: the count's ``stream`` phase (its log line) less
the time inside the reader, mean over the calls."""

from benchmark.metrics._shared import mean_over_calls

SPANS = [{"name": "reader", "kind": "iter",
          "target": "gossamer_tpu_torch.io.native:native_packed_chunks"}]


def read(records):
    return mean_over_calls(records, lambda c: c["phases"]["stream"] - c["spans"]["reader"])
