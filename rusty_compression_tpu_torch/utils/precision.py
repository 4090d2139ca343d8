"""Matmul precision policy (port of ``rusty_compression_tpu.utils.precision``).

On an NVIDIA card, TF32 plays the part that the bf16 MXU default played
on the TPU: an f32 matmul silently carried out with about three decimal
digits. The framework's numerical contracts need true f32 products, so
its entry points run under an explicit policy:

* ``"highest"`` — full f32 (TF32 off). The default.
* ``"high"`` — TF32 tensor-core matmuls allowed.
* ``"default"`` — bf16-based matmuls allowed (``"medium"`` in torch).

Set globally with the ``RC_MATMUL_PRECISION`` environment variable or per
call through the ``precision=`` keyword the decorated functions gain.
The policy is torch's process-wide float32 matmul setting, which also
drives ``torch.backends.cuda.matmul.allow_tf32``; CPU matmuls ignore it.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = ["default_precision", "matmul_precision", "with_precision"]

_VALID = ("highest", "high", "default")
_TORCH_NAME = {"highest": "highest", "high": "high", "default": "medium"}


def default_precision() -> str:
    """The framework-wide default ('highest' unless overridden by the
    ``RC_MATMUL_PRECISION`` environment variable)."""
    p = os.environ.get("RC_MATMUL_PRECISION", "highest")
    if p not in _VALID:
        raise ValueError(
            f"RC_MATMUL_PRECISION={p!r}; expected one of {_VALID}")
    return p


@contextlib.contextmanager
def matmul_precision(precision: str | None = None):
    """Context manager pinning the float32 matmul precision; the previous
    setting is restored on exit."""
    p = precision or default_precision()
    if p not in _VALID:
        raise ValueError(f"precision={p!r}; expected one of {_VALID}")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_TORCH_NAME[p])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def with_precision(fn):
    """Decorator: run ``fn`` under the framework's precision policy.

    The wrapped function gains an optional keyword-only ``precision``
    argument (``"highest" | "high" | "default"``; None = policy default).
    """

    @functools.wraps(fn)
    def wrapper(*args, precision: str | None = None, **kwargs):
        with matmul_precision(precision):
            return fn(*args, **kwargs)

    return wrapper
