"""``python -m repro_torch`` — the profiler's command-line entry point."""

import sys

from repro_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
