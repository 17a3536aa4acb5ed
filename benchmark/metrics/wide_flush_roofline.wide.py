"""The wide batch step (``batch_step_wide``, bound where ``ops.engine_wide``
calls it; PyTorch ops, no kernel of its own): the bound of each call's
lanes and codes (``_wide.py``) over its device ops' time, summed over
calls."""

from benchmark.metrics._shared import roofline_pct
from benchmark.metrics._wide import flush_bound

SPANS = [{"name": "batch_step_wide", "kind": "kernel", "bound": flush_bound,
          "target": "gossamer_tpu_torch.ops.engine_wide:batch_step_wide"}]


def read(records):
    return roofline_pct(records, "batch_step_wide")
