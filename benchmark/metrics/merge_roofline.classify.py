"""Kernel B1 (``merge_sorted``) in the classify join (bound where
``classify.device`` calls it): the bound of each call's lanes over its
device ops' time, summed over calls."""

from benchmark.metrics._shared import merge_bound, roofline_pct

SPANS = [{"name": "merge_sorted", "kind": "kernel", "bound": merge_bound,
          "target": "gossamer_tpu_torch.classify.device:merge_sorted"}]


def read(records):
    return roofline_pct(records, "merge_sorted")
