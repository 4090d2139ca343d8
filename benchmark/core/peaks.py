"""Published peaks of the card, frozen here so that no later change to the
program can move the yardstick.

NVIDIA H100 Tensor Core GPU data sheet, SXM5 column (the part that reports
itself as "NVIDIA H100 80GB HBM3", at its 700 W power limit), dense rates
without sparsity: GPU memory bandwidth 3.35 TB/s; FP64 Tensor Core 67
TFLOPS; FP32 67 TFLOPS (outside the tensor cores). The same numbers stand in the port's ``utils/mfu.py`` and
``chip_smoke.py``; this copy is the benchmark's.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
#: f32 outside the tensor cores: K1 and K2 compute in it (TF32 would be a
#: lower precision than the f32 they promise)
F32_FLOP_PER_S = 67e12
#: f64 on the tensor cores (IEEE f64): the ceiling of K3 and K4
F64_FLOP_PER_S = 67e12
#: the card these peaks are of, as ``torch.cuda.get_device_name()`` gives it
CARD = "NVIDIA H100 80GB HBM3"
