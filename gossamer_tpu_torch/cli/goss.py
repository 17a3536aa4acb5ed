"""``goss`` of the port (reference ``src/GossApp.cc``).

    python -m gossamer_tpu_torch.cli.goss build-graph -k 25 -i reads.fa -O g
"""

from __future__ import annotations

from ..cmds import all_goss_commands
from .framework import App


def build_app() -> App:
    app = App("goss", "goss — de novo assembler (gossamer-tpu, PyTorch port)")
    for cmd in all_goss_commands():
        app.register(cmd)
    return app


def main(argv=None) -> int:
    return build_app().main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
