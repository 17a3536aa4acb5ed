"""Kernel B2 (``merge_fold``, bound where ``ops.engine`` calls it): the
bound of each call's lanes over its device ops' time, summed over calls."""

from benchmark.metrics._shared import fold_bound, roofline_pct

SPANS = [{"name": "merge_fold", "kind": "kernel", "bound": fold_bound,
          "target": "gossamer_tpu_torch.ops.engine:merge_fold"}]


def read(records):
    return roofline_pct(records, "merge_fold")
