"""Command registry (``gossamer_tpu/cmds/__init__.py``, reference
``src/GossCmdReg.cc``): every module's ``COMMANDS`` list, in this order.
A module that fails to import fails the registry."""

from __future__ import annotations

import importlib

MODULES = ("basic", "contigs_cmd", "cleanup", "kmer_set_ops", "assembly",
           "misc", "more", "taxo", "variants")


def all_goss_commands():
    cmds = []
    for name in MODULES:
        cmds += importlib.import_module(f"{__name__}.{name}").COMMANDS
    return cmds
