"""The numbers judged on a two-sided interpolative decomposition ``A ~= C X
R`` (one block, or a stack with a leading batch axis on every field), each
the worst over the blocks:

* ``resid``: ``||A - C X R||_F / ||A||_F``, formed in float64;
* ``skeleton``: ``max |X - A[I, J]| / max |A[I, J]|`` with ``I =
  row_ind[:k]``, ``J = col_ind[:k]``: 0 where X is gathered from A, the
  rounding of its product where it is computed (infinite where I or J is
  not a set of k distinct indices, and then so is ``identity``);
* ``identity``: ``max(|C[I] - 1|, |R[:, J] - 1|)``: the interpolation
  coefficients' identity rows and columns, exact in an ID;
* ``rank_excess`` (with a tolerance): ``k`` less the number of the
  block's singular values at or above ``tol`` times the largest
  (``reference.spectrum``).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import measures, spectrum


def _stack(x: torch.Tensor, batched: bool) -> torch.Tensor:
    return x if batched else x[None]


def _block(a, c, x, r, rows, cols, k) -> dict:
    m, n = a.shape
    values = {"resid": measures.rel_resid(a, c, x.double() @ r.double())}
    if not (measures.is_index_set(rows, m, k)
            and measures.is_index_set(cols, n, k)):
        return {**values, "skeleton": math.inf, "identity": math.inf}
    i, j = rows[:k].long(), cols[:k].long()
    skel = measures.gather(a, i, j).double()
    values["skeleton"] = float((x.double() - skel).abs().max()
                               / skel.abs().max())
    values["identity"] = max(measures.identity_err(c[i]),
                             measures.identity_err(r[:, j]))
    return values


def measure(data: torch.Tensor, out, params: dict,
            gen: torch.Generator) -> dict:
    batched = data.ndim == 3
    blocks = _stack(data, batched)
    c, x, r = (_stack(getattr(out, f), batched) for f in ("c", "x", "r"))
    rows, cols = (_stack(getattr(out, f), batched)
                  for f in ("row_ind", "col_ind"))
    k = x.shape[-1]
    tol = params.get("tol")
    worst: dict = {}
    for b in range(blocks.shape[0]):
        values = _block(blocks[b], c[b], x[b], r[b], rows[b], cols[b], k)
        if tol is not None:
            sigma = spectrum.singular_values(blocks[b], gen)
            values["rank_excess"] = k - spectrum.crossing(sigma, tol)
        for name, value in values.items():
            worst[name] = max(worst.get(name, -math.inf),
                              value if math.isfinite(value) else math.inf)
    return worst
