"""The stored JAX results of the port's tests (``tests/torch_refs/``) are
those of the JAX package as it stands.

Every stored file records the sha256 of each file of
``rusty_compression_tpu/`` and the ``jax`` version it was made with; a
change of either means the stored results may no longer be the JAX
package's. Regenerate them with
``JAX_PLATFORMS=cpu python tests/torch_refs/make_refs.py`` (``--check``
recomputes them into a temporary directory and compares bit for bit).
Each stored result also carries the fingerprint of the inputs it was
recorded on, and a test that builds other inputs cannot read it.
"""

import numpy as np
import pytest

from torch_refs import (EXAMPLE_FILES, INPUTS, SEP, STORE, VALUES, Refs,
                        example_hashes, source_hashes)
from torch_refs.make_refs import FILES
from torch_threads import one_thread  # noqa: F401 (autouse)

STEMS = [f[:-3] for f in FILES]


@pytest.mark.parametrize("stem", STEMS)
def test_stored_results_are_the_packages(stem):
    import jax

    path = STORE / f"{stem}.npz"
    assert path.exists(), f"{path.name} missing: run make_refs.py"
    with np.load(path, allow_pickle=False) as data:
        stored = [str(x) for x in data["__sources__"]]
        version = str(data["__jax__"])
        keys = [k for k in data.files if not k.startswith("__")]
        results = {k.rsplit(SEP, 1)[0] for k in keys}
    now = source_hashes()
    changed = sorted(set(stored) ^ set(now))
    assert not changed, (
        f"{path.name} was made from another rusty_compression_tpu "
        f"({changed[:3]}...); rerun tests/torch_refs/make_refs.py")
    assert version == jax.__version__, (
        f"{path.name} was made with jax {version}; rerun "
        f"tests/torch_refs/make_refs.py")
    assert keys
    for key in results:  # every result names the inputs it was made on
        assert f"{key}{SEP}{INPUTS}" in keys and f"{key}{SEP}{VALUES}" in keys


@pytest.mark.parametrize("stem", sorted(EXAMPLE_FILES))
def test_stored_examples_are_the_programs(stem):
    """A file that mirrors the JAX example programs was made from them as
    they stand (the sha256 of each ``examples/*.py``)."""
    with np.load(STORE / f"{stem}.npz", allow_pickle=False) as data:
        stored = [str(x) for x in data["__examples__"]]
    assert stored and stored == example_hashes(stem), (
        f"{stem}.npz was made from other examples/*.py; rerun "
        f"tests/torch_refs/make_refs.py {stem}.py")


def test_the_store_is_small():
    total = sum(p.stat().st_size for p in STORE.glob("*.npz"))
    assert 0 < total <= 10 * 2 ** 20


@pytest.mark.parametrize("change,raises", [
    ("none", False), ("last bit", False), ("seed", True), ("shape", True),
    ("dtype", True)])
def test_a_stored_result_is_tied_to_its_inputs(change, raises):
    """``test_torch_rsvd.py``'s "svd tolerance" result read back on the
    inputs it was made on, on the same inputs rounded otherwise in their
    last bit, and on inputs of another seed, shape or dtype."""
    from test_torch_parity import low_rank

    refs = Refs(str(STORE.parent / "test_torch_rsvd.py"))
    a = {"none": lambda: low_rank(26, (60, 40), 1e-8, np.float64),
         "last bit": lambda: np.nextafter(
             low_rank(26, (60, 40), 1e-8, np.float64), np.inf),
         "seed": lambda: low_rank(27, (60, 40), 1e-8, np.float64),
         "shape": lambda: low_rank(26, (60, 41), 1e-8, np.float64),
         "dtype": lambda: low_rank(26, (60, 40), 1e-8, np.float32)}[change]()
    if raises:
        with pytest.raises(ValueError, match="make_refs.py"):
            refs("svd tolerance", a, None)
    else:
        want = refs("svd tolerance", a, None)
        assert set(want) == {"s"} and want["s"].ndim == 1
