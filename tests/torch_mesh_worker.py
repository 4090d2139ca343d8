"""One rank of the 4-process Gloo group that ``test_torch_mesh.py`` starts.

    python tests/torch_mesh_worker.py RANK WORLD STORE INPUTS OUT_DIR

Joins the group through the file ``STORE``, builds the (2, 2)
``("blocks", "rows")`` mesh, runs every check of the multi-card layer on
the CPU (one thread) and writes what it found to ``OUT_DIR/rank<RANK>.pkl``
for the test's cases to read. ``INPUTS`` is an ``.npz`` with the JAX
package's sketches and results (made by the test), under the names the
checks below read. Imports torch and the port, never JAX.

Every collective of ``torch.distributed`` is counted (``COUNTS``), so that
a check can say how many a call made.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import os
import pickle
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

COUNTS: collections.Counter = collections.Counter()
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
               "all_gather_into_tensor", "broadcast", "broadcast_object_list",
               "barrier", "reduce", "reduce_scatter", "all_to_all", "gather",
               "scatter", "send", "recv")
METHODS = ("rsvd", "nystrom", "column_id", "row_id", "two_sided_id",
           "sketched_two_sided_id")


def count_collectives() -> None:
    """Wrap each collective of ``torch.distributed`` with a counter (the
    port calls them as ``dist.<name>``, looked up at each call)."""
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def counted(*args, _fn=fn, _name=name, **kwargs):
            COUNTS[_name] += 1
            return _fn(*args, **kwargs)

        setattr(dist, name, counted)


@contextlib.contextmanager
def collectives():
    """``made``: the collectives counted inside the block, by name."""
    before = COUNTS.copy()
    made: dict = {}
    yield made
    made.update({k: v - before[k] for k, v in COUNTS.items()
                 if v != before[k]})


@contextlib.contextmanager
def fed(mats):
    """Make every full-stack draw take the next of ``mats`` (the JAX
    package's sketches), shapes checked: the sharded call then slices
    them as it slices its own draws."""
    from rusty_compression_tpu_torch.utils import random_matrix

    queue, real = list(mats), random_matrix._draw

    def fake(generator, shape, dtype, device):
        mat = torch.as_tensor(queue.pop(0))
        assert tuple(mat.shape) == tuple(shape), (mat.shape, shape)
        return mat.to(dtype=dtype, device=device)

    random_matrix._draw = fake
    try:
        yield queue
    finally:
        random_matrix._draw = real


def fields(container) -> dict:
    """A gathered container (numpy leaves) as a dict of arrays."""
    return {f.name: np.asarray(getattr(container, f.name))
            for f in dataclasses.fields(container)}


def low_rank_stack(seed: int, count: int, m: int, n: int, rank: int,
                   dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((count, m, rank)) @ (
        np.geomspace(1, 1e-6, rank)[:, None] * rng.standard_normal(
            (count, rank, n)))
    return (a + 1e-9 * rng.standard_normal((count, m, n))).astype(dtype)


def decaying(rng, m: int, n: int, decay_rank: int = 20) -> np.ndarray:
    """Spectrum falling by 1e-10 over ``decay_rank`` values (floor 1e-13)."""
    k = min(m, n)
    sig = np.maximum(10.0 ** (-10 * np.arange(k) / (decay_rank - 1)), 1e-13)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    return (u * sig) @ v.T


def digest(results) -> str:
    """sha256 of a stream's results but for the per-rank timings."""
    h = hashlib.sha256()
    for r in results:
        h.update(repr((r.index, r.shape, r.bucket, r.rank, r.rel_residual,
                       r.error)).encode())
        for f in dataclasses.fields(r.factors):
            h.update(np.ascontiguousarray(
                getattr(r.factors, f.name).numpy()).tobytes())
    return h.hexdigest()


def same_results(a, b) -> bool:
    """Two lists of ``BlockResult`` with equal indices, ranks, residuals,
    errors and factors (bitwise)."""
    return len(a) == len(b) and all(
        x.index == y.index and x.rank == y.rank
        and x.rel_residual == y.rel_residual and x.error == y.error
        and all(torch.equal(getattr(x.factors, f.name),
                            getattr(y.factors, f.name))
                for f in dataclasses.fields(x.factors))
        for x, y in zip(a, b))


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def run(rank: int, world: int, store: str, inputs: dict) -> dict:
    from rusty_compression_tpu_torch import cli, config, highacc
    from rusty_compression_tpu_torch import io as rcio
    from rusty_compression_tpu_torch import parallel as par
    from rusty_compression_tpu_torch.models.svd import SVD
    from rusty_compression_tpu_torch.sampling import (_adaptive_loop,
                                                      sample_range_adaptive,
                                                      sample_range_by_rank)

    out: dict = {"rank": rank}
    out["initialize"] = par.initialize(init_method=f"file://{store}",
                                       world_size=world, rank=rank,
                                       device_type="cpu")
    out["initialize_again"] = par.initialize()
    mesh = par.make_mesh(axis_names=("blocks", "rows"), shape=(2, 2),
                         device_type="cpu")
    out["coords"] = (mesh.get_local_rank("blocks"),
                     mesh.get_local_rank("rows"))
    out["local_block_slice"] = par.local_block_slice(10)

    # -- make_mesh and shard errors -----------------------------------------
    errors = {}
    for name, call in {
            "size_not_world": lambda: par.make_mesh(2, device_type="cpu"),
            "shape_not_devices": lambda: par.make_mesh(
                axis_names=("blocks", "rows"), shape=(2, 3),
                device_type="cpu"),
            "shape_required": lambda: par.make_mesh(
                axis_names=("blocks", "rows"), device_type="cpu"),
            "not_divisible": lambda: par.compress_blocks(
                torch.zeros(3, 8, 8, dtype=torch.float64), gen(0), 2,
                mesh=mesh)}.items():
        try:
            call()
            errors[name] = None
        except ValueError as ex:
            errors[name] = str(ex)
    out["errors"] = errors

    # -- compress_blocks: sharded against unsharded, every method -----------
    stacks = {"f64": low_rank_stack(1, 4, 48, 32, 10),
              "f32": low_rank_stack(2, 4, 48, 32, 10, np.float32)}
    out["blocks"] = {}
    for dt, stack in stacks.items():
        blocks = torch.as_tensor(stack)
        for method in METHODS if dt == "f64" else ("rsvd", "column_id"):
            want = par.gather_factors(
                par.compress_blocks(blocks, gen(3), 6, method=method))
            with collectives() as made:
                local = par.compress_blocks(blocks, gen(3), 6,
                                            method=method, mesh=mesh)
            got = par.gather_factors(local, mesh)
            out["blocks"][(dt, method)] = {
                "got": fields(got), "want": fields(want),
                "local_batch": int(getattr(local, dataclasses.fields(
                    local)[0].name).shape[0]), "collectives": made}

    # -- compress_blocks_adaptive: lanes that stop at different rounds ------
    adaptive = torch.as_tensor(inputs["adaptive_blocks"])
    want = par.gather_factors(par.compress_blocks_adaptive(
        adaptive, gen(5), 3e-4, 8, 48))
    reads = _adaptive_loop.host_reads
    with collectives() as made:
        local = par.compress_blocks_adaptive(adaptive, gen(5), 3e-4, 8, 48,
                                             mesh=mesh)
    out["adaptive_reads"] = _adaptive_loop.host_reads - reads
    got = par.gather_factors(local, mesh)
    out["adaptive"] = {"got": got, "want": want, "collectives": made}

    # -- the JAX package's sketches through the sharded calls ---------------
    for key in ("jax_rsvd", "jax_rsvd_live"):
        with fed([inputs[f"{key}/omega"]]):
            svd = par.compress_blocks(torch.as_tensor(inputs[f"{key}/blocks"]),
                                      gen(0), int(inputs[f"{key}/rank"]),
                                      mesh=mesh)
        g = par.gather_factors(svd, mesh)
        out[key] = {"s": g.s, "to_mat": np.einsum(
            "bmk,bk,bkn->bmn", g.u, g.s, g.vt)}
    omegas = [inputs[f"jax_adaptive/omega{i}"]
              for i in range(int(inputs["jax_adaptive/count"]))]
    with fed(omegas) as left:
        svd, ranks, hist = par.compress_blocks_adaptive(
            adaptive, gen(0), 3e-4, 8, 48, mesh=mesh)
    g, granks, ghist = par.gather_factors((svd, ranks, hist), mesh)
    out["jax_adaptive"] = {"ranks": granks, "hist": ghist,
                           "draws": len(omegas) - len(left),
                           "to_mat": np.einsum("bmk,bk,bkn->bmn", g.u,
                                               g.s, g.vt)}

    # -- the refined batch: fixed rounds and growth -------------------------
    rng = np.random.default_rng(7)
    refined = np.stack([decaying(rng, 40, 30, 12 + 4 * i) for i in range(4)])
    out["refined_batch"] = {}
    for mode, kw in {"fixed": dict(rank=16), "growth": dict(tol=1e-8)}.items():
        want = highacc.refined_rsvd_fused_batch(refined, gen(8), **kw)
        reads = highacc._read.count
        with collectives() as made:
            h = highacc.refined_fused_batch_begin(refined, gen(8), mesh=mesh,
                                                  **kw)
        local = highacc.refined_fused_batch_finish(h)
        got = par.gather_factors(local, mesh)
        out["refined_batch"][mode] = {
            "got": [(o.rank, o.u, o.s, o.vt, o.tol_ok) for o in got],
            "want": [(o.rank, o.u.numpy(), o.s.numpy(), o.vt.numpy(),
                      o.tol_ok) for o in want],
            "local": len(local), "collectives": made,
            "reads": highacc._read.count - reads}

    # -- RowShardedOperator over "rows" -------------------------------------
    rng = np.random.default_rng(11)
    out["row_sharded"] = {}
    for dt in ("f32", "c64"):
        a = rng.standard_normal((64, 20)) @ np.diag(
            np.geomspace(1, 1e-6, 20)) @ rng.standard_normal((20, 20))
        if dt == "c64":
            a = a + 1j * (rng.standard_normal((64, 20)) @ rng.standard_normal(
                (20, 20)) * 1e-3)
        a = torch.as_tensor(a.astype(np.float32 if dt == "f32"
                                     else np.complex64))
        op = par.RowShardedOperator(a, mesh, "rows")
        x = torch.as_tensor(rng.standard_normal((20, 3))).to(a.dtype)
        y = torch.as_tensor(rng.standard_normal((64, 3))).to(a.dtype)
        with collectives() as mm:
            ax = op.matmat(x)
        with collectives() as cm:
            ahy = op.conj_matmat(y)
        out["row_sharded"][dt] = {
            "local_rows": op.a.shape[0], "matmat": ax.numpy(),
            "conj_matmat": ahy.numpy(), "want_matmat": (a @ x).numpy(),
            "want_conj_matmat": (a.mH @ y).numpy(),
            "matmat_collectives": mm, "conj_matmat_collectives": cm}
    a = torch.as_tensor(rng.standard_normal((64, 40)) @ np.diag(
        np.geomspace(1, 1e-10, 40)) @ rng.standard_normal((40, 40)))
    op = par.RowShardedOperator(a, mesh, "rows")
    q = sample_range_by_rank(op, gen(5), 20, 5)
    svd = SVD.compute_from_range_estimate(q, op)
    q2, hist = sample_range_adaptive(op, gen(6), 1e-5, 10)
    dense = par.RowShardedOperator(a, mesh, "rows").to_dense()
    out["row_sampling"] = {
        "by_rank": float(torch.linalg.matrix_norm(q @ (q.T @ a) - a)
                         / torch.linalg.matrix_norm(a)),
        "svd": float(torch.linalg.matrix_norm(svd.to_mat() - a)
                     / torch.linalg.matrix_norm(a)),
        "adaptive": float(torch.linalg.matrix_norm(q2 @ (q2.T @ a) - a)
                          / torch.linalg.matrix_norm(a)),
        "rounds": len(hist), "to_dense": bool(torch.equal(dense, a))}

    # -- the block streams on the mesh --------------------------------------
    rng = np.random.default_rng(12)
    shapes = [(40, 30)] * 5 + [(70, 45)] * 3   # neither group divides by 2
    stream = [decaying(rng, m, n) for m, n in shapes]
    out["stream"] = {}
    for name, kw in {"rsvd": dict(rank=10, method="rsvd"),
                     "column_id": dict(rank=10, method="column_id"),
                     "tolerance": dict(rel_tol=1e-4, sample_size=8)}.items():
        seen: list = []
        got = par.compress_heterogeneous(stream, gen(9), mesh=mesh,
                                         bucket_floor=32,
                                         on_result=seen.append, **kw)
        want = par.compress_heterogeneous(stream, gen(9), batch_granule=2,
                                          bucket_floor=32, **kw)
        out["stream"][name] = {
            "order": [r.index for r in got], "seen": [r.index for r in seen],
            "equal": same_results(got, want), "digest": digest(got),
            "worst": max(r.rel_residual for r in got),
            "ranks": [r.rank for r in got]}
    shapes = [(40, 30)] * 6 + [(70, 45)] * 2    # chunks of even counts
    stream = [decaying(rng, m, n) for m, n in shapes]
    for name, rr in {"refined_fixed": 36, "refined_growth": None}.items():
        with collectives() as made:
            got = par.compress_heterogeneous_refined(
                stream, gen(4), rel_tol=1e-8, round_rank=rr,
                bucket_floor=32, mesh=mesh)
        want = par.compress_heterogeneous_refined(
            stream, gen(4), rel_tol=1e-8, round_rank=rr, bucket_floor=32)
        out["stream"][name] = {
            "order": [r.index for r in got], "equal": same_results(got, want),
            "digest": digest(got), "errors": [r.error for r in got],
            "worst": max(r.rel_residual for r in got),
            "ranks": [r.rank for r in got],
            "want_ranks": [r.rank for r in want],
            "max_rec_diff": max(float((
                (x.factors.u * x.factors.s) @ x.factors.vt
                - (y.factors.u * y.factors.s) @ y.factors.vt).abs().max())
                for x, y in zip(got, want)),
            "collectives": made}

    # -- the front door on the mesh -----------------------------------------
    blocks = torch.as_tensor(stacks["f64"])
    cfg = config.CompressionConfig.RANK(6, method="column_id")
    got = par.gather_factors(config.compress(blocks, gen(2), cfg, mesh=mesh),
                             mesh)
    want = par.gather_factors(config.compress(blocks, gen(2), cfg))
    front = {"stack": all(np.array_equal(got_, want_) for got_, want_ in
                          zip(fields(got).values(), fields(want).values()))}
    cfg = config.CompressionConfig.RANK(10)
    front["list"] = same_results(
        config.compress(list(stream), gen(2), cfg, mesh=mesh),
        config.compress(list(stream), gen(2), cfg))
    cfg = config.CompressionConfig.ADAPTIVE(1e-8, highacc=True, round_rank=16)
    got = par.gather_factors(config.compress(refined, gen(2), cfg, mesh=mesh),
                             mesh)
    want = config.compress(refined, gen(2), cfg)
    front["highacc_stack"] = len(got) == len(want) and all(
        np.array_equal(x.u, y.u.numpy()) and np.array_equal(x.s, y.s.numpy())
        for x, y in zip(got, want))
    front["highacc_list"] = same_results(
        config.compress(list(stream), gen(2), cfg, mesh=mesh),
        config.compress(list(stream), gen(2), cfg))
    try:
        config.compress(blocks[0], gen(2), cfg, mesh=mesh)
        front["one_matrix_refused"] = False
    except ValueError:
        front["one_matrix_refused"] = True
    out["front_door"] = front

    # -- the CLI over the group: rank 0 writes, --resume on every rank ------
    work = inputs["cli_dir"].item()
    src = os.path.join(work, "blocks")
    ckpt = os.path.join(work, "ckpt")
    if rank == 0:
        os.makedirs(src, exist_ok=True)
        for i, b in enumerate(stream):
            np.save(os.path.join(src, f"b{i:02d}.npy"), b)
    dist.barrier()
    argv = [src, "-o", ckpt, "--tol", "1e-8", "--highacc", "--round-rank",
            "24", "--bucket-floor", "32", "--device", "cpu", "--mesh"]
    out["cli_rc"] = cli.main(argv)
    manifest = os.path.join(ckpt, "manifest.jsonl")
    dist.barrier()
    if rank == 0:
        with open(manifest) as f:
            rows = f.readlines()
        with open(manifest, "w") as f:
            f.writelines(rows[:-3])
    dist.barrier()
    out["cli_pending"] = rcio.pending_blocks(ckpt, len(stream))
    dist.barrier()
    out["cli_resume_rc"] = cli.main(argv + ["--resume"])
    dist.barrier()
    out["cli_rows"] = [r["block"] for r in rcio.load_block_results(ckpt, device="cpu")]
    with open(manifest) as f:
        out["cli_manifest_lines"] = len(f.readlines())
    dist.barrier()
    out["collectives_total"] = dict(COUNTS)
    return out


def main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    store, inputs_path, out_dir = argv[3], argv[4], argv[5]
    torch.set_num_threads(1)
    count_collectives()
    with np.load(inputs_path) as z:
        inputs = {k: z[k] for k in z.files}
    try:
        out = run(rank, world, store, inputs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with tempfile.NamedTemporaryFile("wb", dir=out_dir, delete=False) as f:
        pickle.dump(out, f)
    os.replace(f.name, os.path.join(out_dir, f"rank{rank}.pkl"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
