"""`python -m galileo_sdr_sim_tpu_torch` runs the CLI (cli.py)."""

import sys

from .cli import main

sys.exit(main())
