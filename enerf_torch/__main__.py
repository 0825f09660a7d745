"""`python -m enerf_torch --config FILE [flags]`: the port's command line
(enerf_torch/cli.py, which says what it runs)."""

import sys

from enerf_torch.cli import get_select_frames, main  # noqa: F401  (the CLI's names)

if __name__ == "__main__":
    main(sys.argv[1:])
