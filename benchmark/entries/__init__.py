"""Entries: one module per program entry a cell drives.  Each holds an
``Entry`` class (see ``harness.Context`` for what it gets): ``prepare``,
``call`` (one whole CLI call, in-process; its exit code), ``after_call``
(between calls: the records of the call and a digest of what it wrote),
``work`` (one call's work, by name: the quantities the end-to-end
rates divide by the calls' walls), ``compare``
(the last call's output against ``reference/``: each number with its
limit) and ``notes``; ``SPANS`` are the spans that name the trace's idle
gaps."""
