"""Command-line front-end over the ``repro_torch.analysis`` Session API.

``python -m repro_torch <command>`` (or ``python -m repro_torch.cli``)
exposes the paper's tools without writing Python: see
``repro_torch.cli.main`` for the subcommands and
``repro_torch.cli.workloads`` for the declarative workload arguments.
Import surface: ``main(argv) -> int``.
"""

from repro_torch.cli.main import build_parser, main  # noqa: F401
