"""Stored results of the JAX package for the port's tests.

The port's test files compare the PyTorch port with the JAX package on the
same numpy-seeded inputs. Most of their cost was the JAX package's own work
(compiling and running its programs on the CPU), the same on every run. So
a converted test asks ``Refs`` for the JAX side of a comparison by name:

    refs = Refs(__file__)
    want = refs("stack/rsvd", a, lambda: {"s": rc.compress(a, ...).s, ...})

``want`` is a dict of numpy arrays, read from ``tests/torch_refs/<test file
stem>.npz``. The inputs are not stored: the test rebuilds them from their
seeds and hands them (``a`` above: arrays, tensors, scalars, or lists,
tuples and dicts of them) to ``refs``, which stores their ``fingerprint``
beside the key and raises at read time when the test's inputs no longer
match it, so a changed seed or shape cannot pass against results recorded
on other inputs. The function is called only when
``make_refs.py`` records (it sets
``RC_TORCH_REFS_RECORD`` to a directory for the pytest run it starts); it
returns a dict whose values are arrays, scalars, strings, sequences of
scalars (stored as one array) or lists of arrays. Each stored file carries
the sha256 of every file of the JAX package and the ``jax`` version it was
made with; ``tests/test_torch_refs.py`` fails when the package has changed
since. Each converted file keeps a small case live (no ``Refs``), so the
comparison with the running reference never goes wholly through the store.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

RECORD_ENV = "RC_TORCH_REFS_RECORD"
STORE = Path(__file__).resolve().parent
PACKAGE = STORE.parents[1] / "rusty_compression_tpu"
SEP = "|"


def source_hashes() -> list[str]:
    """``"<path> <sha256>"`` of every file of the JAX package, sorted by
    path (caches of compiled bytecode left out)."""
    out = []
    for path in sorted(PACKAGE.rglob("*")):
        if (path.is_dir() or "__pycache__" in path.parts
                or path.suffix == ".pyc"):
            continue
        rel = path.relative_to(PACKAGE.parent).as_posix()
        out.append(f"{rel} {hashlib.sha256(path.read_bytes()).hexdigest()}")
    return out


#: the example programs whose JAX calls a stored file mirrors, by its stem
EXAMPLE_FILES = {"test_torch_examples": sorted(
    (STORE.parents[1] / "examples").glob("*.py"))}


def example_hashes(stem: str) -> list[str]:
    """``"<path> <sha256>"`` of each example program ``stem`` mirrors."""
    root = STORE.parents[1]
    return [f"{p.relative_to(root).as_posix()} "
            f"{hashlib.sha256(p.read_bytes()).hexdigest()}"
            for p in EXAMPLE_FILES.get(stem, [])]


#: the names under a key that hold the fingerprint of the test's inputs
INPUTS, VALUES = "@inputs", "@values"
#: how far a fingerprint's values may move (another BLAS may round the
#: inputs' last bits otherwise; a changed seed or shape moves them by O(1))
FINGERPRINT_RTOL = 1e-9


def _walk(x, layout: list, values: list) -> None:
    if isinstance(x, dict):
        layout.append(f"{{{len(x)}")
        for k in sorted(x, key=repr):
            layout.append(repr(k))
            _walk(x[k], layout, values)
    elif isinstance(x, (list, tuple)):
        layout.append(f"[{len(x)}")
        for item in x:
            _walk(item, layout, values)
    elif hasattr(x, "detach"):  # a torch tensor
        _walk(x.detach().cpu().resolve_conj().numpy(), layout, values)
    elif isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        layout.append(f"{a.dtype.str}{a.shape}")
        flat = a.astype(np.complex128).ravel()
        w = np.random.default_rng(flat.size).standard_normal(flat.size)
        proj = w @ flat
        norm = float(np.linalg.norm(flat))
        scale = norm * np.sqrt(max(flat.size, 1))
        values += [(norm, norm), (proj.real, scale), (proj.imag, scale)]
    else:
        layout.append(repr(x))


def fingerprint(inputs) -> tuple[str, np.ndarray]:
    """A test's inputs as ``(layout, values)``: the sha256 of their
    structure, dtypes, shapes and non-array values, which must match
    exactly, and for each array its norm and its product with a fixed
    random vector, with the scale each is compared at (rows of
    ``values``)."""
    layout: list = []
    values: list = []
    _walk(inputs, layout, values)
    return (hashlib.sha256("|".join(layout).encode()).hexdigest(),
            np.asarray(values, dtype=np.float64).reshape(-1, 2))


def _same_inputs(stored: dict, inputs) -> bool:
    layout, values = fingerprint(inputs)
    want = np.asarray(stored.get(VALUES, np.empty((0, 2))))
    return (str(stored.get(INPUTS)) == layout and want.shape == values.shape
            and bool(np.all(np.abs(values[:, 0] - want[:, 0])
                            <= FINGERPRINT_RTOL * want[:, 1])))


def _flatten(key: str, value: dict) -> dict[str, np.ndarray]:
    flat = {f"{key}{SEP}": np.asarray(0)}  # the key, even with no values
    for name, v in value.items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)) and all(np.ndim(x) == 0 for x in v):
            flat[f"{key}{SEP}{name}"] = np.asarray(v)  # shapes, histories
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                flat[f"{key}{SEP}{name}#{i}"] = np.asarray(item)
            flat[f"{key}{SEP}{name}#len"] = np.asarray(len(v))
        else:
            flat[f"{key}{SEP}{name}"] = np.asarray(v)
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> dict[str, dict]:
    out: dict[str, dict] = {}
    lists: dict[tuple, int] = {}
    for full, arr in flat.items():
        key, name = full.rsplit(SEP, 1)
        out.setdefault(key, {})
        if not name:
            continue
        if "#" in name:
            base, idx = name.rsplit("#", 1)
            if idx == "len":
                lists[(key, base)] = int(arr)
            continue
        out.setdefault(key, {})[name] = arr
    for (key, base), count in lists.items():
        out.setdefault(key, {})[base] = [
            flat[f"{key}{SEP}{base}#{i}"] for i in range(count)]
    return out


class Refs:
    """The stored JAX results of one test file (see the module docstring)."""

    def __init__(self, test_file: str):
        self.stem = Path(test_file).stem
        self._loaded: dict | None = None

    @property
    def path(self) -> Path:
        return STORE / f"{self.stem}.npz"

    def _load(self) -> dict:
        if self._loaded is None:
            with np.load(self.path, allow_pickle=False) as data:
                flat = {k: data[k] for k in data.files
                        if not k.startswith("__")}
            self._loaded = _unflatten(flat)
        return self._loaded

    def __call__(self, key: str, inputs, fn) -> dict:
        """The JAX results ``fn()`` stored under ``key``, recorded on
        ``inputs`` (see the module docstring)."""
        record = os.environ.get(RECORD_ENV)
        if record:
            layout, values = fingerprint(inputs)
            flat = _flatten(key, {**fn(), INPUTS: layout, VALUES: values})
            out_dir = Path(record) / self.stem
            out_dir.mkdir(parents=True, exist_ok=True)
            name = hashlib.sha256(key.encode()).hexdigest()[:24]
            np.savez(out_dir / f"{name}.npz", **flat)
            stored = _unflatten(flat)[key]
        else:
            loaded = self._load()
            if key not in loaded:
                raise KeyError(
                    f"no stored JAX result {key!r} in {self.path.name}; run "
                    f"python tests/torch_refs/make_refs.py")
            stored = loaded[key]
            if not _same_inputs(stored, inputs):
                raise ValueError(
                    f"the stored JAX result {key!r} in {self.path.name} was "
                    f"recorded on other inputs than this test builds; run "
                    f"python tests/torch_refs/make_refs.py")
        return {k: v for k, v in stored.items() if k not in (INPUTS, VALUES)}
