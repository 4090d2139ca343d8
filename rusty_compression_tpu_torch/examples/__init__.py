"""Twins of the JAX package's example programs (``examples/*.py``).

One module for each example, under the same name, run as

    python -m rusty_compression_tpu_torch.examples.<name>

Each has ``run(...)``, which takes the example's numpy inputs and a
``torch.Generator`` (whose device it runs on) and returns the numbers the
example checks as a dict, and ``main(device=None)``, which makes the
example's inputs, prints its lines and makes its checks, on the card
unless the caller names ``"cpu"``. The JAX examples compute in f32 on a
TPU and in f64 elsewhere; the card has native f64, so every twin takes
the f64 branch, the reference's semantics. A twin imports nothing of the
JAX package and nothing from ``examples/``: what it needs from there (the
H-matrix cluster tree and partition) it keeps a copy of.
"""

from __future__ import annotations

import time

import torch

__all__ = ["resolve_device", "device_name", "example_mesh", "seconds_since",
           "gate"]


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when none is named; raises when the card is
    asked for and there is none (a twin never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or the device."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def example_mesh():
    """A ``DeviceMesh`` over the process group when ``torch.distributed``
    runs more than one process, else None (one card needs no mesh)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from ..parallel import make_mesh

        return make_mesh()
    return None


def seconds_since(t0: float, device: torch.device) -> float:
    """Host seconds since ``t0``, after the device's queued work ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def gate(ok: bool, what) -> None:
    """An example's check: raises ``AssertionError`` with ``what`` when it
    fails (as the JAX example's ``assert`` does, but also under ``-O``)."""
    if not ok:
        raise AssertionError(what)
