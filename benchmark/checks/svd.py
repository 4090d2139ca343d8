"""The numbers judged on a truncated SVD ``A ~= U diag(s) Vt`` (one block,
or a stack with a leading batch axis on every field), each the worst over
the blocks:

* ``resid``: ``||A - U diag(s) Vt||_F / ||A||_F``, formed in float64;
* ``orth``: ``max(|U^T U - I|, |Vt Vt^T - I|)``, entrywise;
* ``proj``: ``||U^T A - diag(s) Vt||_F / ||A||_F``: zero in exact
  arithmetic for factors taken from the core ``B = Q^T A``; it carries the
  rounding of the core's product and of its small SVD;
* with a tolerance, against the block's singular values
  (``reference.spectrum``): ``sv_err``, ``max_i |s_i - sigma_i| /
  sigma_0`` over the kept ones, and ``rank_gap``, ``|k - crossing|``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import measures, spectrum


def _stack(x: torch.Tensor, batched: bool, dims: int) -> torch.Tensor:
    return x if batched else x.reshape(1, *x.shape[-dims:])


def measure(data: torch.Tensor, out, params: dict,
            gen: torch.Generator) -> dict:
    batched = data.ndim == 3
    blocks = data if batched else data[None]
    u, vt = (_stack(getattr(out, f), batched, 2) for f in ("u", "vt"))
    s = _stack(out.s, batched, 1)
    tol = params.get("tol")
    worst = {"resid": 0.0, "orth": 0.0, "proj": 0.0}
    if tol is not None:
        worst.update(sv_err=0.0, rank_gap=0.0)
    for b in range(blocks.shape[0]):
        a = blocks[b]
        k = s.shape[-1]
        values = {
            "resid": measures.rel_resid(a, u[b].double() * s[b].double(),
                                        vt[b]),
            "orth": max(measures.orth_err(u[b]), measures.orth_err(vt[b].T)),
            "proj": measures.proj_resid(a, u[b], s[b], vt[b]),
        }
        if tol is not None:
            sigma = spectrum.singular_values(a, gen)
            kk = min(k, sigma.shape[0])
            sv = s[b].double().cpu().numpy()[:kk]
            values["sv_err"] = float(abs(sv - sigma[:kk]).max() / sigma[0])
            values["rank_gap"] = abs(k - spectrum.crossing(sigma, tol))
        for name, value in values.items():
            worst[name] = max(worst[name], value if math.isfinite(value)
                              else math.inf)
    return worst
