"""The port's loader of the C++ host planner (``native.py``) against the
Python planner of ``parallel.scheduler``.

The library is built from ``native/rc_native.cpp`` into the port's
``_build/`` (never into ``native/``, the JAX package's build, which
``tests/test_native.py`` builds with ``make``); this file does not call
the JAX package's ``native`` module.
"""

import numpy as np
import pytest

from test_torch_parity import port  # noqa: F401
from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def nat(port):
    from rusty_compression_tpu_torch import native

    if not native.available():
        pytest.skip("no C++ compiler to build native/rc_native.cpp")
    return native


def shapes_of(seed, count=300):
    rng = np.random.default_rng(seed)
    return [tuple(int(d) for d in s) for s in rng.integers(1, 5000,
                                                           (count, 2))]


def test_the_build_goes_into_the_ports_build_dir(nat):
    from pathlib import Path

    import rusty_compression_tpu_torch as rt

    lib = nat.library_path()
    assert lib.parent == Path(rt.__file__).parent / "_build"
    assert lib.exists() and lib.name.startswith("librc_native_")
    assert not list(lib.parent.glob("*.so.tmp*"))


@pytest.mark.parametrize("seed,floor,granule", [(0, 128, 1), (1, 64, 4),
                                                (2, 256, 8)])
def test_plan_equals_the_python_planner(nat, seed, floor, granule):
    from rusty_compression_tpu_torch.parallel import scheduler as sc

    shapes = shapes_of(seed)
    plan = nat.plan(shapes, floor, granule)
    groups = sc.plan_buckets(shapes, floor)
    assert plan.groups() == groups
    assert list(plan.groups()) == sorted(groups)  # ascending buckets
    batches = [sc._batch_bucket(len(v), granule)
               for _, v in sorted(groups.items())]
    assert plan.group_batch.tolist() == batches
    for elem in (4, 8):
        assert plan.padded_bytes(elem) == sum(
            b * bm * bn * elem
            for b, ((bm, bn), _) in zip(batches, sorted(groups.items())))
    slots = plan.gather_slots()
    width = max(batches)
    for gi, (_, idxs) in enumerate(sorted(groups.items())):
        for slot, i in enumerate(idxs):
            assert slots[i] == gi * width + slot


def test_chunk_batch_equals_the_python_mirror(nat, monkeypatch):
    from rusty_compression_tpu_torch.parallel import scheduler as sc

    grid = [(c, g, bm, bn, e, b) for c in (1, 3, 17, 1000) for g in (1, 2, 8)
            for bm, bn in ((128, 128), (4096, 1024)) for e in (4, 8, 16)
            for b in (-1, 0, 1 << 16, 1 << 28, 1 << 30)]
    want = [nat.chunk_batch(*args) for args in grid]
    monkeypatch.setattr(nat, "chunk_batch", lambda *a: None)
    assert [sc._chunk_batch(*args) for args in grid] == want


def test_invalid_inputs_raise(nat):
    with pytest.raises(ValueError, match="invalid plan"):
        nat.plan([(4, 0)])
    with pytest.raises(ValueError, match="invalid plan"):
        nat.plan([(4, 4)], floor=0)
    with pytest.raises(ValueError, match="invalid chunk_batch"):
        nat.chunk_batch(0, 1, 128, 128, 4, 1 << 20)
    empty = nat.plan([])
    assert empty.groups() == {} and empty.gather_slots().size == 0
