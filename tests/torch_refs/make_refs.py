"""Write the stored JAX results of the port's tests (``tests/torch_refs/*.npz``).

    JAX_PLATFORMS=cpu python tests/torch_refs/make_refs.py          # write
    JAX_PLATFORMS=cpu python tests/torch_refs/make_refs.py --check  # compare

Runs the converted test files once with pytest in one process on the CPU,
with ``RC_TORCH_REFS_RECORD`` naming a temporary directory: every
``Refs(...)`` call there computes its JAX side on the tests' own
numpy-seeded inputs and records it. The records of each test file are then
bundled into one compressed ``<test file stem>.npz`` together with the
sha256 of every file of the JAX package (``__sources__``) and the ``jax``
version (``__jax__``). ``--check`` writes the bundles into a temporary
directory instead and compares every stored array with the committed one,
bit for bit; it exits non-zero on any difference.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
TESTS = HERE.parent
sys.path.insert(0, str(TESTS))

from torch_refs import (RECORD_ENV, example_hashes,  # noqa: E402
                        source_hashes)

#: the test files whose JAX side is stored
FILES = [
    "test_torch_highacc.py", "test_torch_highacc_id.py",
    "test_torch_config.py", "test_torch_linop.py", "test_torch_nystrom.py",
    "test_torch_adaptive.py", "test_torch_rsvd.py", "test_torch_scheduler.py",
    "test_torch_mesh.py", "test_torch_examples.py",
]


def record(out_dir: Path, files=FILES) -> None:
    """Run the test ``files`` in record mode and bundle their records into
    ``out_dir``."""
    import jax

    with tempfile.TemporaryDirectory() as raw:
        env = dict(os.environ, JAX_PLATFORMS="cpu", **{RECORD_ENV: raw})
        subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
             "-p", "no:cacheprovider", "-p", "no:randomly",
             *[str(TESTS / f) for f in files]],
            cwd=TESTS.parent, env=env, check=True)
        sources = np.asarray(source_hashes())
        for stem_dir in sorted(Path(raw).iterdir()):
            arrays = {}
            for part in sorted(stem_dir.glob("*.npz")):
                with np.load(part, allow_pickle=False) as data:
                    arrays.update({k: data[k] for k in data.files})
            examples = example_hashes(stem_dir.name)
            if examples:
                arrays["__examples__"] = np.asarray(examples)
            np.savez_compressed(out_dir / f"{stem_dir.name}.npz",
                                __sources__=sources,
                                __jax__=np.asarray(jax.__version__),
                                **arrays)


def compare(new_dir: Path) -> list[str]:
    """Differences between the bundles in ``new_dir`` and the committed
    ones."""
    problems = []
    for new in sorted(new_dir.glob("*.npz")):
        old = HERE / new.name
        if not old.exists():
            problems.append(f"{new.name}: not committed")
            continue
        with np.load(new) as a, np.load(old) as b:
            if set(a.files) != set(b.files):
                problems.append(f"{new.name}: keys differ: "
                                f"{sorted(set(a.files) ^ set(b.files))[:5]}")
            for key in sorted(set(a.files) & set(b.files)):
                x, y = a[key], b[key]
                if x.dtype != y.dtype or x.shape != y.shape or \
                        x.tobytes() != y.tobytes():
                    problems.append(f"{new.name}: {key} differs")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="regenerate into a temporary directory and compare "
                         "with the committed files, bit for bit")
    ap.add_argument("files", nargs="*", default=FILES,
                    help="the test files to record (default: all of them)")
    args = ap.parse_args(argv)
    if not args.check:
        record(HERE, args.files)
        total = sum(p.stat().st_size for p in HERE.glob("*.npz"))
        print(f"wrote {len(list(HERE.glob('*.npz')))} files, {total} bytes")
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        record(Path(tmp), args.files)
        problems = compare(Path(tmp))
    for line in problems:
        print(line)
    print("identical" if not problems else f"{len(problems)} differences")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
