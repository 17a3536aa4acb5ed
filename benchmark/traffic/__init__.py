"""Traffic generators: one module each, found by the ``generator`` a mix
file (``traffic/<mix>.json``) names.  Each has ``make(config, mix, seed,
workdir) -> dict``: the inputs as arrays for the reference and as files
for the program, all from ``seed``."""
