"""Command/CLI framework.

Counterpart of ``gossamer_tpu/cli/framework.py``: the reference's
three-tier App/registry design (``src/App.cc:176-419``,
``src/GossCmdReg.hh:26``, ``src/GossOption.cc``) with option names and
short flags of ``src/GossApp.cc:145-203``.  In place of the JAX backend
probe, the global ``--device`` option names the torch device every
command runs on.  It is never changed behind the user's back: asking for
CUDA where there is none raises.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..io.factory import FileFactory, PhysicalFileFactory
from ..utils.logging import Logger


class CommandError(Exception):
    """User-facing command failure (bad options, bad input...)."""


def resolve_device(name: str) -> torch.device:
    """``--device`` -> ``torch.device``; raises when it is not usable."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is "
                           f"false; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"--device {name}: only cuda and cpu are supported")
    return device


@dataclass
class Context:
    """Per-invocation context (``src/GossCmdContext.hh:25``)."""

    fac: FileFactory
    log: Logger
    opts: argparse.Namespace
    device: torch.device
    debug_flags: set = field(default_factory=set)

    def debug(self, flag: str) -> bool:
        # hidden feature-flag system (reference ``src/Debug.cc``)
        return flag in self.debug_flags


@dataclass
class Command:
    name: str
    help: str
    add_options: Callable[[argparse.ArgumentParser], None]
    run: Callable[[Context], None]


class App:
    def __init__(self, prog: str, description: str):
        self.prog = prog
        self.description = description
        self.commands: dict[str, Command] = {}

    def register(self, cmd: Command) -> None:
        self.commands[cmd.name] = cmd

    def build_parser(self) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(prog=self.prog, description=self.description)
        sub = p.add_subparsers(dest="command", metavar="command")
        for name in sorted(self.commands):
            cmd = self.commands[name]
            sp = sub.add_parser(name, help=cmd.help)
            add_global_options(sp)
            cmd.add_options(sp)
        return p

    def main(self, argv=None) -> int:
        argv = list(sys.argv[1:] if argv is None else argv)
        if argv and argv[0] in ("--version", "-V"):
            from .. import __version__

            print(f"{self.prog} version {__version__} (gossamer-tpu-torch)")
            return 0
        parser = self.build_parser()
        ns = parser.parse_args(argv)
        if not ns.command:
            parser.print_help()
            return 1
        device = resolve_device(ns.device)
        if ns.kill_signal:
            from ..utils.batch_task import KillSignal

            KillSignal.register(ns.kill_signal)
        fac = PhysicalFileFactory(tmp_dir=(ns.tmp_dir[0] if ns.tmp_dir else None))
        log = Logger(ns.log_file, verbose=ns.verbose, fac=None)
        log("debug", f"device: {device}")
        ctx = Context(fac=fac, log=log, opts=ns, device=device,
                      debug_flags=set(ns.debug or []))
        # hidden profiler (reference Profile.hh scopes): -D print-profile
        # reports this call's scopes and counters, then restores the switch
        from ..utils import profile

        profiling = ctx.debug("print-profile")
        was_on = profile.enabled()
        if profiling:
            profile.reset()
            profile.enable()
        try:
            self.commands[ns.command].run(ctx)
            return 0
        except CommandError as e:
            print(f"{self.prog}: {e}", file=sys.stderr)
            return 1
        except FileNotFoundError as e:
            print(f"{self.prog}: file not found: {e}", file=sys.stderr)
            return 1
        except Exception:
            traceback.print_exc()
            return 1
        finally:
            if profiling:
                profile.report()
                profile.enable(was_on)
            log.close()


def add_global_options(p: argparse.ArgumentParser) -> None:
    """Global tier (``src/GossApp.cc:145-152``), ``--kill-signal`` and
    ``--device``."""
    p.add_argument("-D", "--debug", action="append", default=[],
                   help="enable particular debugging output")
    p.add_argument("-l", "--log-file", default=None,
                   help="place to write messages")
    p.add_argument("--tmp-dir", action="append", default=[],
                   help="a directory to use for temporary files")
    p.add_argument("-T", "--num-threads", type=int, default=4,
                   help="maximum number of worker threads (host pipeline)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="show progress messages")
    p.add_argument("--kill-signal", default=None, metavar="FILE",
                   help="exit when FILE appears (cooperative kill for "
                        "pipeline drivers; src/GossKillSignal.hh)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")


def add_input_options(p: argparse.ArgumentParser) -> None:
    """Read-source tier (``src/GossApp.cc:154-160``)."""
    p.add_argument("-I", "--fasta-in", action="append", default=[],
                   help="input file in FASTA format")
    p.add_argument("-F", "--fastas-in", action="append", default=[],
                   help="file containing FASTA filenames")
    p.add_argument("-i", "--fastq-in", action="append", default=[],
                   help="input file in FASTQ format")
    p.add_argument("-f", "--fastqs-in", action="append", default=[],
                   help="file containing FASTQ filenames")
    p.add_argument("--line-in", action="append", default=[],
                   help="input file with one sequence per line")


def gather_read_files(ctx: Context) -> list[tuple[str, str]]:
    """Expand input options to [(filename, format)] in option order."""
    o = ctx.opts
    out: list[tuple[str, str]] = []
    for name in o.fasta_in:
        out.append((name, "fasta"))
    for name in o.fastq_in:
        out.append((name, "fastq"))
    for name in getattr(o, "line_in", []):
        out.append((name, "line"))
    for listfile in o.fastas_in:
        for line in ctx.fac.read_text(listfile).splitlines():
            if line.strip():
                out.append((line.strip(), "fasta"))
    for listfile in o.fastqs_in:
        for line in ctx.fac.read_text(listfile).splitlines():
            if line.strip():
                out.append((line.strip(), "fastq"))
    if not out:
        raise CommandError("no input files given (use -I/-i/-F/-f/--line-in)")
    return out


def iter_reads(ctx: Context, files=None):
    from ..io.readers import read_file

    for name, fmt in files if files is not None else gather_read_files(ctx):
        yield from read_file(name, ctx.fac, fmt)
