"""Stage spans of the port (``utils.profiling.span``).

With no profiler recording, a span is one shared null context. Under
``torch.profiler`` the pipelines emit the tree of stages that the
benchmark's per-layer readers take apart: ``rc.capture`` with one
``rc.capture.round`` a growth round, each round's ``rc.range_finder``, and
``rc.finish`` with ``rc.host_svd`` (rSVD) or ``rc.core_pivot`` and
``rc.row_id`` (two-sided ID); a rank-k stack emits ``rc.range_finder`` and
``rc.project_svd``. The spans change no factor and add no host read."""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rusty_compression_tpu_torch import highacc, highacc_id
from rusty_compression_tpu_torch.config import CompressionConfig, compress
from rusty_compression_tpu_torch.utils import profiling

TOL = 1e-8


def decaying(seed: int, m: int = 80, n: int = 96) -> torch.Tensor:
    """An f64 block whose singular values run from 1 to 1e-12: the growth
    capture at tol 1e-8 takes two rounds of 32 columns."""
    rng = np.random.default_rng(seed)
    k = min(m, n)
    u = np.linalg.qr(rng.standard_normal((m, k)))[0]
    v = np.linalg.qr(rng.standard_normal((n, k)))[0]
    return torch.from_numpy((u * np.geomspace(1, 1e-12, k)) @ v.T)


def stack(seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(3, 40, 32, generator=g)


def rounds(a: torch.Tensor, seed: int) -> int:
    """Growth rounds of the capture that the entries run on ``a``."""
    gen = torch.Generator().manual_seed(seed)
    return len(highacc.refined_capture(a, gen, tol=TOL)[2])


ENTRIES = {
    "rsvd": (lambda a, g: highacc.refined_rsvd(a, g, tol=TOL), decaying),
    "two_sided_id": (lambda a, g: highacc_id.refined_two_sided_id(
        a, g, tol=TOL), decaying),
    "stack_rank": (lambda a, g: compress(a, g, CompressionConfig(rank=4)),
                   stack),
}


def tree(r: int, entry: str) -> Counter:
    """(span, parent) of every span a call of ``entry`` emits, with ``r``
    growth rounds."""
    if entry == "stack_rank":
        return Counter({("rc.range_finder", None): 1,
                        ("rc.project_svd", None): 1})
    capture = Counter({("rc.capture", None): 1,
                       ("rc.capture.round", "rc.capture"): r,
                       ("rc.range_finder", "rc.capture.round"): r})
    if entry == "rsvd":
        return capture + Counter({("rc.finish", None): 1,
                                  ("rc.host_svd", "rc.finish"): 1})
    return capture + Counter({("rc.finish", None): 2,
                              ("rc.core_pivot", "rc.finish"): 1,
                              ("rc.row_id", "rc.finish"): 1})


def spans_of(prof) -> Counter:
    """(name, parent) of the profiler's ``rc.`` spans, the parent
    being the innermost ``rc.`` span that contains the span."""
    spans = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns()),
                    e.name()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("rc."))
    out, stack = Counter(), []
    for start, neg_end, name in spans:
        while stack and -stack[-1][1] < start:
            stack.pop()
        out[(name, stack[-1][2] if stack else None)] += 1
        stack.append((start, neg_end, name))
    return out


def tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from tensors(getattr(x, name))


def test_span_is_one_shared_null_context_when_no_profiler_runs():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("rc.capture")
    assert off is profiling.span("rc.finish")
    assert isinstance(off, contextlib.nullcontext)
    with off, off:  # reentrant
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("rc.capture")
        assert on is not off and not isinstance(on, contextlib.nullcontext)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_form_the_stage_tree_and_change_nothing(entry):
    fn, make = ENTRIES[entry]
    a = make(5)
    outs, reads = [], []
    for traced in (False, True):
        start = highacc._read.count
        gen = torch.Generator().manual_seed(7)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                outs.append(fn(a, gen))
        else:
            outs.append(fn(a, gen))
        reads.append(highacc._read.count - start)
    assert reads[0] == reads[1]
    off, on = (list(tensors(o)) for o in outs)
    assert off and len(off) == len(on)
    assert all(torch.equal(x, y) for x, y in zip(off, on))
    r = 0 if entry == "stack_rank" else rounds(a, 7)
    assert entry == "stack_rank" or r >= 2
    assert spans_of(prof) == tree(r, entry)
