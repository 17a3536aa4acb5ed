"""The plain reference: straightforward torch code of the original
gossamer's semantics (data61/gossamer), written for this benchmark and
independent of the program.  It imports nothing of ``gossamer_tpu_torch``,
``gossamer_tpu`` or ``jax``, takes the inputs the traffic generators made
and nothing the program made, and runs on any torch device, in blocks of
rows."""
