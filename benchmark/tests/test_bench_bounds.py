"""The frozen copies: ``core/bounds.panel_bound`` equals
``chip_smoke.py::panel_bound`` on the benchmark's shapes, and
``core/peaks`` holds the published H100 numbers."""

import pytest
import torch

import chip_smoke
from benchmark.core import bounds, peaks

SHAPES = [((32, 24, 16384), 16, torch.float32, False),   # K1 on the sketch
          ((32, 16, 16384), 16, torch.float32, False),   # K1 on C's LQ
          ((24, 16384), 16, torch.float32, False),
          ((1, 256, 8192), 256, torch.float64, False),   # K3 on the core
          ((1, 169, 8192), 169, torch.float64, False),   # K3 on C^H
          ((72, 1024), 64, torch.float64, True),
          ((53, 8192), 43, torch.complex64, False),
          ((64, 2048), 64, torch.complex128, False)]


@pytest.mark.parametrize("shape, k, dtype, masked", SHAPES)
def test_panel_bound_is_chip_smokes(shape, k, dtype, masked):
    assert bounds.panel_bound(shape, k, dtype, masked) == \
        chip_smoke.panel_bound(shape, k, dtype, masked)


def test_peaks_are_the_data_sheets():
    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S == 3.35e12
    assert peaks.F32_FLOP_PER_S == chip_smoke.F32_FLOP_PER_S == 67e12
    assert peaks.F64_FLOP_PER_S == chip_smoke.F64_FLOP_PER_S == 67e12
    assert bounds.WIDE_DTYPES == (torch.float64, torch.complex128)
