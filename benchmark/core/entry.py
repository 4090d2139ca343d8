"""The call a cell's window makes: the port's entry that the traffic file
names, with its arguments.

A traffic file names the entry by its dotted path inside
``rusty_compression_tpu_torch`` and gives its keywords; where it has a
``compression_config``, the entry is ``compress`` and gets a
``CompressionConfig`` built from it. A cell's control (``cells/*.json``)
is a plain reference pipeline of ``reference/pipelines.py`` put in the
program's place, on the data in a lower precision, with the traffic's
keywords and its own.
"""

from __future__ import annotations

import importlib

import torch

PORT = "rusty_compression_tpu_torch"


def program_seed(seed: int) -> int:
    """The seed of the generator that the entry draws its sketches from:
    another stream than the data's."""
    return (int(seed) * 0x9E3779B1 + 0x7F4A7C15) % 2 ** 63


def _resolve(path: str):
    module, _, attr = path.rpartition(".")
    if module.split(".")[0] != PORT:
        raise ValueError(f"entry {path!r} is not in {PORT}")
    return getattr(importlib.import_module(module), attr)


def make_call(traffic: dict, data: torch.Tensor, seed: int,
              control: dict | None = None):
    """A function of no arguments that runs one call of the cell on
    ``data``, drawing from one generator seeded from ``seed`` (each call
    goes on where the last one left the generator)."""
    gen = torch.Generator(device=data.device).manual_seed(program_seed(seed))
    kwargs = dict(traffic.get("kwargs", {}))
    cc = traffic.get("compression_config")
    if control is not None:
        from benchmark.reference import pipelines

        fn = getattr(pipelines, control["pipeline"])
        low = getattr(torch, control["dtype"])
        low_data = data.to(low)
        kwargs.update(control.get("kwargs", {}))
        return lambda: fn(low_data, gen, **kwargs)
    fn = _resolve(traffic["entry"])
    if cc is not None:
        config = _resolve(f"{PORT}.config.CompressionConfig")(**cc)
        return lambda: fn(data, gen, config, **kwargs)
    return lambda: fn(data, gen, **kwargs)
