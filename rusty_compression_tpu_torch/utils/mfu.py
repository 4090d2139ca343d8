"""Peak FLOP/s and memory-rate model for utilization figures (port of
``rusty_compression_tpu.utils.mfu``).

An achieved FLOP/s or bytes/s figure means something only beside the
ceiling it could have reached. The JAX package keyed TPU peaks on
``jax.Device.device_kind``; here the table is keyed on the name the card
reports, ``torch.cuda.get_device_name()``, and holds NVIDIA's data-sheet
peaks (dense, no sparsity). The f32 matmul precision policy
(``utils.precision``) picks the rate a matmul can reach:

* ``"highest"``: true f32, outside the tensor cores;
* ``"high"``: TF32 tensor cores;
* ``"default"``: bf16 tensor cores.

Those rates assume the card's full power limit (700 W for the H100 SXM);
a card set below it runs slower under load. A card not in the table (and
the CPU) gives None: no figure is guessed, and none of the TPU's is used.
"""

from __future__ import annotations

__all__ = ["effective_peak_flops", "mfu_pct", "hbm_peak_bytes",
           "hbm_util_pct"]

# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column (the part that
# reports "NVIDIA H100 80GB HBM3", 700 W): FP32 67 TFLOPS, TF32 Tensor
# Core 494.7 TFLOPS and BF16 Tensor Core 989.4 TFLOPS dense (the sheet
# prints twice these "with sparsity"), GPU memory bandwidth 3.35 TB/s.
_PEAKS = {
    "nvidia h100 80gb hbm3": {
        "highest": 67e12,
        "high": 494.7e12,
        "default": 989.4e12,
    },
}

_HBM_PEAKS = {
    "nvidia h100 80gb hbm3": 3.35e12,
}

_PRECISIONS = ("highest", "high", "default")


def effective_peak_flops(device_name: str, precision: str) -> float | None:
    """Dense matmul peak of the card named ``device_name`` under the given
    matmul precision; None when the card has no table entry."""
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    peaks = _PEAKS.get(device_name.strip().lower())
    return None if peaks is None else peaks[precision]


def mfu_pct(flops: float, seconds: float, device_name: str,
            precision: str) -> float | None:
    """Achieved fraction of the effective peak, in percent (None when the
    card's peak is unknown, e.g. on the CPU)."""
    peak = effective_peak_flops(device_name, precision)
    if peak is None or seconds <= 0:
        return None
    return 100.0 * flops / seconds / peak


def hbm_peak_bytes(device_name: str) -> float | None:
    """Memory bandwidth of the card named ``device_name`` (None when
    unknown)."""
    return _HBM_PEAKS.get(device_name.strip().lower())


def hbm_util_pct(bytes_moved: float, seconds: float,
                 device_name: str) -> float | None:
    """Modeled memory traffic as a fraction of the bandwidth ceiling, in
    percent (None when the card has no table entry)."""
    peak = hbm_peak_bytes(device_name)
    if peak is None or seconds <= 0:
        return None
    return 100.0 * bytes_moved / seconds / peak
