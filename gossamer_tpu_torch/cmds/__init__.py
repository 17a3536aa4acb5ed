"""Command registry (``gossamer_tpu/cmds/__init__.py``): build-graph,
build-kmer-set and dump-kmer-set."""


def all_goss_commands():
    from .basic import COMMANDS

    return list(COMMANDS)
