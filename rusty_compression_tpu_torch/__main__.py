"""``python -m rusty_compression_tpu_torch`` runs the block-compression CLI."""

import sys

from .cli import main

sys.exit(main())
