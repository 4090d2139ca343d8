"""The port's multi-card layer (``parallel.mesh``, ``parallel.sharded``,
``parallel.distributed``, ``mesh=`` on the stack, stream, 1e-8 and CLI
paths) on the CPU, through a 4-process Gloo group.

One module-scoped fixture starts the group once: four processes of
``tests/torch_mesh_worker.py`` (one thread each) join through a store file,
build the (2, 2) ``("blocks", "rows")`` mesh, run every check and write what
they found; the cases below read it, so each check counts as a case. The
group has a deadline of 120 s: past it the ranks are killed and every case
fails.

The rule for "sharded equals unsharded": bitwise. Each rank draws what the
unsharded call draws and runs the same batched pipeline on its slice, and
the CPU's batched LAPACK and BLAS work block by block, so the CPU gives it
for every method, the adaptive stack, the refined batch's fixed rounds and
both streams. The one exception is the refined batch's growth, whose rule
its case states: a rank stops growing when its own lanes have crossed.

The JAX side: the JAX package's sharded ``compress_blocks`` and
``compress_blocks_adaptive`` on its 8 virtual CPU devices (``make_mesh(4)``,
as ``tests/test_parallel.py:68``), with its sketches fed to the port's
sharded calls, stored in ``tests/torch_refs/test_torch_mesh.npz`` by
``make_refs.py``; one small rSVD case runs live.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rusty_compression_tpu import parallel as jpar
from test_torch_parity import (decade_block, jax_adaptive_omegas_stack,
                               jax_gaussian)
from torch_refs import Refs
from torch_threads import one_thread  # noqa: F401 (autouse)

refs = Refs(__file__)
WORLD = 4
DEADLINE_S = 120
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_worker.py")
METHODS = ("rsvd", "nystrom", "column_id", "row_id", "two_sided_id",
           "sketched_two_sided_id")
ADAPTIVE_SHAPE = (96, 64)


def jax_rsvd(blocks: np.ndarray, seed: int, rank: int) -> dict:
    """The JAX package's sharded rSVD of ``blocks`` and its sketch."""
    key = jax.random.key(seed)
    svd = jpar.compress_blocks(jnp.asarray(blocks), key, rank=rank,
                               method="rsvd", mesh=jpar.make_mesh(4))
    omega = np.stack([jax_gaussian(k, (blocks.shape[2], rank + 5),
                                   blocks.dtype)
                      for k in jax.random.split(key, blocks.shape[0])])
    return {"s": svd.s, "to_mat": jax.vmap(lambda f: f.to_mat())(svd),
            "omega": omega}


def inputs_and_jax() -> tuple[dict, dict]:
    """The workers' inputs (the JAX sketches among them) and the JAX
    results the cases compare with."""
    rng = np.random.default_rng(31)
    rsvd_blocks = rng.standard_normal((8, 48, 32)) @ np.diag(
        np.geomspace(1, 1e-10, 32)) @ rng.standard_normal((8, 32, 32))
    live_blocks = rng.standard_normal((4, 24, 16))
    # two fast lanes on the first "blocks" coordinate, two slow ones on the
    # second: the ranks' loops run different numbers of rounds
    adaptive = np.stack([decade_block(40 + i, ADAPTIVE_SHAPE, per)
                         for i, per in enumerate((4, 4, 16, 16))])

    def adaptive_side():
        key = jax.random.key(89)
        svd, ranks, hist = jpar.compress_blocks_adaptive(
            jnp.asarray(adaptive), key, 3e-4, 8, 48, mesh=jpar.make_mesh(4))
        return {"ranks": ranks, "hist": hist,
                "to_mat": jax.vmap(lambda f: f.to_mat())(svd),
                "omegas": jax_adaptive_omegas_stack(
                    key, 4, ADAPTIVE_SHAPE[1], 8, 7, np.float64)}

    want = {"jax_rsvd": refs("rsvd", rsvd_blocks,
                             lambda: jax_rsvd(rsvd_blocks, 11, 16)),
            "jax_rsvd_live": jax_rsvd(live_blocks, 12, 6),
            "jax_adaptive": refs("adaptive", adaptive, adaptive_side)}
    inputs = {"adaptive_blocks": adaptive,
              "jax_rsvd/blocks": rsvd_blocks, "jax_rsvd/rank": 16,
              "jax_rsvd/omega": want["jax_rsvd"]["omega"],
              "jax_rsvd_live/blocks": live_blocks, "jax_rsvd_live/rank": 6,
              "jax_rsvd_live/omega": want["jax_rsvd_live"]["omega"],
              "jax_adaptive/count": len(want["jax_adaptive"]["omegas"])}
    for i, om in enumerate(want["jax_adaptive"]["omegas"]):
        inputs[f"jax_adaptive/omega{i}"] = om
    return inputs, want


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """``(outs, want, seconds)``: the four ranks' findings, rank order; the
    JAX results; the group's wall time."""
    work = tmp_path_factory.mktemp("mesh")
    inputs, want = inputs_and_jax()
    inputs["cli_dir"] = np.asarray(str(work / "cli"))
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(work / "store"),
         str(work / "inputs.npz"), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            left = DEADLINE_S - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(left, 1))[0].decode())
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD}-rank group passed its {DEADLINE_S} s "
                    "deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    outs = []
    for r in range(WORLD):
        with open(work / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs, want, seconds


def same(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# compress_blocks / compress_blocks_adaptive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,method",
                         [("f64", m) for m in METHODS]
                         + [("f32", "rsvd"), ("f32", "column_id")])
def test_sharded_compress_blocks_is_the_unsharded_call(group, dtype, method):
    """Each rank computes its half of the stack (the "blocks" axis has 2);
    gathered, the factors are bitwise the unsharded call's, on every rank."""
    outs, _, _ = group
    for out in outs:
        case = out["blocks"][(dtype, method)]
        assert case["local_batch"] == 2
        assert same(case["got"], case["want"]), (out["rank"], method)


def test_sharded_adaptive_is_the_unsharded_call(group):
    outs, _, _ = group
    for out in outs:
        (got, granks, ghist), (want, wranks, whist) = (
            out["adaptive"]["got"], out["adaptive"]["want"])
        np.testing.assert_array_equal(granks, wranks)
        np.testing.assert_array_equal(ghist, whist)
        for name in ("u", "s", "vt"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


def test_the_ranks_adaptive_loops_stop_at_their_own_rounds(group):
    """Per-device stopping: the ranks of the fast lanes read their stop flag
    fewer times than the ranks of the slow ones."""
    outs, _, _ = group
    reads = {out["coords"][0]: out["adaptive_reads"] for out in outs}
    assert reads[0] < reads[1], reads
    ranks = outs[0]["adaptive"]["got"][1]
    assert max(ranks[:2]) < min(ranks[2:]), ranks


@pytest.mark.parametrize("call", ["compress_blocks",
                                  "compress_blocks_adaptive",
                                  "refined_fused_batch_begin"])
def test_the_compute_makes_no_collective(group, call):
    """The port's form of ``test_parallel.py:204``: every collective of
    ``torch.distributed`` is counted in the workers; the sharded compute
    makes none (a stop flag read inside a collective would deadlock ranks
    that stop at different rounds)."""
    outs, _, _ = group
    for out in outs:
        if call == "compress_blocks":
            made = [c["collectives"] for c in out["blocks"].values()]
        elif call == "compress_blocks_adaptive":
            made = [out["adaptive"]["collectives"]]
        else:
            made = [c["collectives"] for c in out["refined_batch"].values()]
        assert all(m == {} for m in made), made


# ---------------------------------------------------------------------------
# Against the JAX package's sharded calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["jax_rsvd", "jax_rsvd_live"])
def test_sharded_rsvd_matches_the_jax_package(group, key):
    """The JAX package's sketches fed to the port's sharded rSVD (each rank
    slices its blocks' part out of the whole stack's draw): singular
    values to 1e-10 relative, reconstructions to 1e-10 (f64). The live
    case runs the JAX side here."""
    outs, want, _ = group
    for out in outs:
        got = out[key]
        np.testing.assert_allclose(got["s"], np.asarray(want[key]["s"]),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got["to_mat"],
                                   np.asarray(want[key]["to_mat"]),
                                   atol=1e-10)


def test_sharded_adaptive_matches_the_jax_package(group):
    """The JAX package's per-lane draws through the port's sharded adaptive
    loop: ranks equal, histories to 1e-6 relative (as
    ``test_torch_adaptive.py``), reconstructions to 1e-9; each rank drew
    only the rounds its own lanes needed."""
    outs, want, _ = group
    ref = want["jax_adaptive"]
    live = ref["hist"][ref["hist"] > 0]
    assert np.all((live > 1.5 * 3e-4) | (live < 3e-4 / 1.5)), live
    draws = {}
    for out in outs:
        got = out["jax_adaptive"]
        np.testing.assert_array_equal(got["ranks"], ref["ranks"])
        np.testing.assert_allclose(got["hist"], ref["hist"], rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(got["to_mat"], ref["to_mat"], atol=1e-9)
        draws[out["coords"][0]] = got["draws"]
    assert draws[0] < draws[1] <= len(ref["omegas"]), draws


# ---------------------------------------------------------------------------
# The refined batch, the row-sharded operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fixed", "growth"])
def test_sharded_refined_batch_is_the_unsharded_call(group, mode):
    """``refined_fused_batch_begin(mesh=)``: each rank captures and finishes
    its two blocks (its own host core SVDs). Fixed rounds: gathered,
    bitwise the unsharded batch. Growth: a rank stops when its own lanes
    have crossed, so its basis carries fewer zero columns than the
    unsharded stack's and its QR and core SVD round differently; the
    rule is then ranks and ``tol_ok`` equal, singular values and
    reconstructions within 1e-12 of the largest (f64)."""
    outs, _, _ = group
    for out in outs:
        case = out["refined_batch"][mode]
        assert case["local"] == 2
        assert len(case["got"]) == len(case["want"]) == 4
        for (gk, gu, gs, gvt, gok), (wk, wu, ws, wvt, wok) in zip(
                case["got"], case["want"]):
            assert (gk, gok) == (wk, wok)
            if mode == "fixed":
                for g, w in ((gu, wu), (gs, ws), (gvt, wvt)):
                    np.testing.assert_array_equal(g, w)
                continue
            np.testing.assert_allclose(gs, ws, atol=1e-12 * ws[0], rtol=0)
            np.testing.assert_allclose((gu * gs) @ gvt, (wu * ws) @ wvt,
                                       atol=1e-12 * ws[0], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "c64"])
def test_row_sharded_products(group, dtype):
    """Each rank holds 32 of the 64 rows; both products equal the dense
    ones (f32 / c64 rounding: 1e-5 of the largest entry)."""
    outs, _, _ = group
    for out in outs:
        case = out["row_sharded"][dtype]
        assert case["local_rows"] == 32
        for name in ("matmat", "conj_matmat"):
            want = case[f"want_{name}"]
            np.testing.assert_allclose(case[name], want,
                                       atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["f32", "c64"])
def test_row_sharded_products_make_one_collective_each(group, dtype):
    outs, _, _ = group
    for out in outs:
        case = out["row_sharded"][dtype]
        assert case["matmat_collectives"] == {"all_gather": 1}
        assert case["conj_matmat_collectives"] == {"all_reduce": 1}


@pytest.mark.parametrize("what", ["by_rank", "svd", "adaptive"])
def test_samplers_run_unmodified_on_a_row_sharded_operator(group, what):
    """``sample_range_by_rank``, ``SVD.compute_from_range_estimate`` and the
    adaptive sampler through the sharded products, as
    ``test_parallel.py:104-120`` (projection residual < 1e-4)."""
    outs, _, _ = group
    for out in outs:
        case = out["row_sampling"]
        assert case[what] < 1e-4, case
        assert case["rounds"] >= 1 and case["to_dense"]


# ---------------------------------------------------------------------------
# The block streams on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rsvd", "column_id", "tolerance"])
def test_stream_on_the_mesh_is_the_padded_unsharded_stream(group, name):
    """Five (40, 30) and three (70, 45) blocks: each chunk is padded to a
    multiple of the "blocks" size (2) and each rank packs and compresses
    its own slots; the results are bitwise those of the unsharded stream
    with ``batch_granule=2``, in submission order, ``on_result`` once per
    block and never for a padding slot (as ``test_parallel.py:190``)."""
    outs, _, _ = group
    for out in outs:
        case = out["stream"][name]
        assert case["order"] == list(range(8))
        assert sorted(case["seen"]) == list(range(8))
        assert case["equal"]
        # rank 10 of spectra falling by 1e-10 over 20 values: sigma_11 ~
        # 10^(-100 / 19), as test_parallel.py:200 gates
        assert case["worst"] < (5e-4 if name == "tolerance"
                                else 10 * 10 ** (-100 / 19))


@pytest.mark.parametrize("name", ["refined_fixed", "refined_growth"])
def test_refined_stream_on_the_mesh(group, name):
    """Six (40, 30) and two (70, 45) blocks at 1e-8 (as
    ``test_parallel.py:390``): chunks of even counts, so the sharded stream
    is the unsharded one bitwise; no block fails its gate; the only
    collectives are the per-chunk gathers of results."""
    outs, _, _ = group
    for out in outs:
        case = out["stream"][name]
        assert case["order"] == list(range(8))
        assert case["equal"], (case["ranks"], case["want_ranks"],
                               case["max_rec_diff"])
        assert case["errors"] == [None] * 8
        assert case["worst"] < 5e-8
        assert set(case["collectives"]) == {"all_gather_object"}


@pytest.mark.parametrize("name", ["rsvd", "column_id", "tolerance",
                                  "refined_fixed", "refined_growth"])
def test_every_rank_returns_the_same_stream(group, name):
    digests = {out["stream"][name]["digest"] for out in group[0]}
    assert len(digests) == 1


@pytest.mark.parametrize("route", ["stack", "list", "highacc_stack",
                                   "highacc_list", "one_matrix_refused"])
def test_compress_on_the_mesh(group, route):
    """``compress(..., mesh=)``: a stack (gathered) and a list bitwise the
    unsharded calls, and so with ``highacc=True``; one matrix with a mesh
    raises."""
    for out in group[0]:
        assert out["front_door"][route], (out["rank"], route)


def test_cli_mesh_with_resume(group):
    """``cli --mesh --highacc`` over the 4-rank group: rank 0 writes the
    manifest, every rank reads it; after 3 rows are deleted, ``--resume``
    re-runs those 3 blocks only, and every block has one row."""
    for out in group[0]:
        assert out["cli_rc"] == out["cli_resume_rc"] == 0
        assert out["cli_pending"] == [5, 6, 7]
        assert out["cli_rows"] == list(range(8))
        assert out["cli_manifest_lines"] == 8


# ---------------------------------------------------------------------------
# Groups, meshes, errors, gathering
# ---------------------------------------------------------------------------


def test_local_block_slice_partitions_everything(group):
    """Contiguous slices by rank, covering every block once (as
    ``test_parallel.py:256``, here across four processes); each rank joined
    the group (``initialize`` True, and True again) and sits at its own
    mesh coordinate."""
    outs, _, seconds = group
    assert [out["initialize"] for out in outs] == [True] * WORLD
    assert [out["initialize_again"] for out in outs] == [True] * WORLD
    assert sorted(out["coords"] for out in outs) == [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]
    assert seconds < DEADLINE_S
    slices = [out["local_block_slice"] for out in outs]
    assert [(s.start, s.stop) for s in slices] == [(0, 3), (3, 6), (6, 9),
                                                   (9, 10)]


@pytest.mark.parametrize("name,words", [
    ("size_not_world", "process group of 4"),
    ("shape_not_devices", "mesh shape (2, 3) != 4 devices"),
    ("shape_required", "shape required for multi-axis meshes"),
    ("not_divisible", "pad the stack (see parallel.scheduler) first")])
def test_mesh_errors(group, name, words):
    for out in group[0]:
        assert out["errors"][name] is not None and words in \
            out["errors"][name], out["errors"][name]


def test_gather_factors_layout(group):
    """``gather_factors`` gives the unsharded layout as numpy: a batched
    container along its leading axis, a list of per-block results in
    submission order."""
    out = group[0][0]
    got = out["blocks"][("f64", "rsvd")]["got"]
    assert {k: v.shape for k, v in got.items()} == {
        "u": (4, 48, 6), "s": (4, 6), "vt": (4, 6, 32)}
    assert all(isinstance(v, np.ndarray) for v in got.values())
    refined = out["refined_batch"]["fixed"]["got"]
    assert [r[0] for r in refined] == [16] * 4
    assert all(isinstance(r[1], np.ndarray) for r in refined)


# ---------------------------------------------------------------------------
# In this process: no group, or a group of one
# ---------------------------------------------------------------------------


def test_initialize_without_a_launcher_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from rusty_compression_tpu_torch import parallel as par

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert par.initialize() is False
    assert not dist.is_initialized()
    assert par.local_block_slice(7) == slice(0, 7)


def test_make_mesh_on_cuda_without_a_card_raises():
    import torch
    import torch.distributed as dist

    from rusty_compression_tpu_torch import parallel as par

    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh()
    assert not dist.is_initialized()


def test_a_group_of_one_in_process():
    """``make_mesh(device_type="cpu")`` with no group makes one of one rank
    from an in-process store: the sharded call is the unsharded one
    bitwise. The group is destroyed at the end, so it cannot leak into the
    next test of this worker."""
    import torch
    import torch.distributed as dist

    from rusty_compression_tpu_torch import parallel as par

    blocks = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 20, 12)))
    try:
        mesh = par.make_mesh(device_type="cpu")
        assert dist.get_world_size() == 1
        got = par.compress_blocks(blocks, torch.Generator().manual_seed(1),
                                  4, mesh=mesh)
        want = par.compress_blocks(blocks, torch.Generator().manual_seed(1),
                                   4)
        assert all(torch.equal(getattr(got, f), getattr(want, f))
                   for f in ("u", "s", "vt"))
        gathered = par.gather_factors(got, mesh)
        assert np.array_equal(gathered.u, want.u.numpy())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()
