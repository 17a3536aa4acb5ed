"""Kernel B1 (``merge_sorted``) in the count's finish (bound where
``ops.engine`` calls it): the bound of each call's lanes over its device
ops' time, summed over calls."""

from benchmark.metrics._shared import merge_bound, roofline_pct

SPANS = [{"name": "merge_sorted", "kind": "kernel", "bound": merge_bound,
          "target": "gossamer_tpu_torch.ops.engine:merge_sorted"}]


def read(records):
    return roofline_pct(records, "merge_sorted")
