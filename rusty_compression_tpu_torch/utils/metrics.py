"""Relative-error metrics (port of ``rusty_compression_tpu.utils.metrics``)."""

from __future__ import annotations

import torch

__all__ = ["rel_diff_fro", "rel_diff_l2"]


def rel_diff_fro(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """``||first - second||_F / ||second||_F`` over the last two axes
    (single matrices or batches; returns a real scalar per matrix)."""
    diff = torch.linalg.matrix_norm(first - second, ord="fro")
    return diff / torch.linalg.matrix_norm(second, ord="fro")


def rel_diff_l2(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """``||first - second||_2 / ||second||_2`` for vectors (last axis)."""
    diff = torch.linalg.vector_norm(first - second, dim=-1)
    return diff / torch.linalg.vector_norm(second, dim=-1)
