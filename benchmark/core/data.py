"""The input data of a cell, made on the device from ``--seed``.

One general generator: BEM Laplace single-layer blocks ``K[i, j] = 1 /
(4 pi |x_i - y_j|)`` between a cloud of targets and a cloud of sources,
each uniform in a cube (centre and half-width from the configuration's
file). The clouds of all blocks are drawn in one call each from a
``torch.Generator`` on the device seeded with ``--seed``, so the same seed
gives the same blocks; the blocks are then built one at a time into the
stack, since a block's build holds two planes of its size.

This is the benchmark's own code: the port's ``laplace_kernel_block`` is
not used, so that the inputs both sides see are made by neither.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def dtype_of(config: dict) -> torch.dtype:
    return DTYPES[config["dtype"]]


def shape_of(config: dict) -> tuple[int, ...]:
    """``(m, n)`` for a configuration laid out as one matrix, ``(B, m, n)``
    for a stack."""
    m, n = int(config["rows"]), int(config["cols"])
    if config["layout"] == "matrix":
        if int(config["blocks"]) != 1:
            raise ValueError("a 'matrix' layout holds one block")
        return (m, n)
    if config["layout"] != "stack":
        raise ValueError(f"unknown layout {config['layout']!r}")
    return (int(config["blocks"]), m, n)


def block_bytes(config: dict) -> int:
    """Bytes of matrix data one call compresses: every block, once."""
    return math.prod(shape_of(config)) * dtype_of(config).itemsize


def _cloud(gen: torch.Generator, count: int, size: int, cloud: dict,
           device) -> torch.Tensor:
    """(count, size, 3) points, f64, uniform in the cloud's cube."""
    u = torch.rand((count, size, 3), generator=gen, dtype=torch.float64,
                   device=device)
    centre = torch.tensor(cloud["center"], dtype=torch.float64,
                          device=device)
    return centre + float(cloud["half_width"]) * (2.0 * u - 1.0)


def laplace_block(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor):
    """``out[i, j] = 1 / (4 pi |x_i - y_j|)`` in ``out``'s dtype, the
    squared distance summed one coordinate at a time."""
    x, y = x.to(out.dtype), y.to(out.dtype)
    d2 = torch.zeros_like(out)
    for c in range(3):
        d2 += (x[:, None, c] - y[None, :, c]).square_()
    out.copy_(d2.sqrt_().mul_(4.0 * math.pi).reciprocal_())


def make_data(config: dict, seed: int, device) -> torch.Tensor:
    """The configuration's blocks for ``seed`` on ``device``."""
    if config["generator"] != "laplace_blocks":
        raise ValueError(f"unknown generator {config['generator']!r}")
    shape = shape_of(config)
    count, m, n = (1, *shape) if len(shape) == 2 else shape
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = _cloud(gen, count, m, config["targets"], device)
    y = _cloud(gen, count, n, config["sources"], device)
    data = torch.empty((count, m, n), dtype=dtype_of(config), device=device)
    for b in range(count):
        laplace_block(x[b], y[b], data[b])
    return data[0] if len(shape) == 2 else data
