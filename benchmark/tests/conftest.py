"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of the repository (the card's tests skip without a card; on the
card machine they run as they are)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Sizes a CPU test can hold, per configuration (the cells' own sizes run
#: on the card only).
SMALL = {"bem_block_8k_f64": {"rows": 384, "cols": 320},
         "bem_stack_16k_f32": {"blocks": 4, "rows": 256, "cols": 320}}


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)
