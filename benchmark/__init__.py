"""The benchmark of gossamer_tpu_torch: see README.md."""
