"""``python -m repro_torch.cli`` — same entry as ``python -m repro_torch``."""

import sys

from repro_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
