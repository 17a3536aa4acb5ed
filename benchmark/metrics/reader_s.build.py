"""Host seconds a build-graph call spends inside the chunk iterator of the
native reader (``io.native.native_packed_chunks``), mean over the calls."""

from benchmark.metrics._shared import span_s

SPANS = [{"name": "reader", "kind": "iter",
          "target": "gossamer_tpu_torch.io.native:native_packed_chunks"}]


def read(records):
    return span_s(records, "reader")
