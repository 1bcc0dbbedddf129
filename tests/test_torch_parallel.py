"""`dynamicrafter_tpu_torch.parallel.sharding` against the JAX package's
`parallel/sharding.py` (its asserts, `tests/test_sharding_utils.py`) and
the ZeRO layout's collectives on two and three spawned `gloo` processes on
the CPU.

`run_ranks` is the harness of every multi-process test of the port: each
rank is a spawned process with one torch thread, joined to its group by a
FileStore under the test's tmp_path (no port to pick, so tests under xdist
cannot collide), and the parent fails if a rank exits nonzero or is still
running at the timeout (a collective one rank skipped hangs the others),
killing what is left.
"""
import multiprocessing
import os
import time
import traceback
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynamicrafter_tpu_torch.parallel import sharding  # noqa: E402
from dynamicrafter_tpu_torch.parallel.sharding import (  # noqa: E402
    DATA_AXIS, SEQ_AXIS, FlatShards, Mesh, active_mesh, create_mesh, shard_bounds, use_mesh,
)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """One intra-op thread in the parent too: the tensors are tiny, and more
    threads only contend with the other test workers (as in
    tests/test_torch_samplers.py, whose module the spawned ranks should not
    import: it imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank_entry(fn, rank, world, store, errdir, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        sharding.init_distributed("cpu", store)
        fn(rank, world, *args)
        sharding.barrier(sharding.create_mesh(world))
    except BaseException:
        with open(os.path.join(errdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        sharding.destroy_distributed()


def run_ranks(fn, world, tmp_path, *args, timeout=240):
    """fn(rank, world, *args) in `world` spawned processes joined by a gloo
    group; fails on a nonzero exit or at `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    run_dir = tmp_path / f"ranks_{uuid.uuid4().hex[:8]}"
    run_dir.mkdir()
    store = str(run_dir / "store")
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, store, str(run_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        stuck = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not stuck, f"ranks {stuck} still running after {timeout} s"
        codes = [p.exitcode for p in procs]
        errors = {f.name: f.read_text() for f in run_dir.glob("rank*.err")}
        assert codes == [0] * world, f"exit codes {codes}: {errors}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def test_create_mesh_shapes():
    """JAX's shapes and asserts (tests/test_sharding_utils.py), over
    processes instead of devices."""
    mesh = create_mesh(dp=2, sp=1, world_size=2, rank=1)
    assert mesh.shape == {"dp": 2, "sp": 1} and mesh.dp == 2 and mesh.rank == 1
    assert mesh.world_size == 2 and mesh.group is None     # no process group here
    assert create_mesh(dp=1, sp=-1).shape == {DATA_AXIS: 1, SEQ_AXIS: 1}
    assert create_mesh(dp=8, sp=-1, world_size=8).shape == {"dp": 8, "sp": 1}
    with pytest.raises(AssertionError):
        create_mesh(dp=3, sp=-1, world_size=8)      # 8 % 3 != 0
    with pytest.raises(AssertionError):
        create_mesh(dp=2, sp=2, world_size=8)       # 2 x 2 != 8


@pytest.mark.parametrize("dp,sp", [(1, -1), (2, 4), (4, 2), (1, 8)])
def test_sp_raises_naming_item_k(dp, sp):
    """sp > 1 builds the mesh (it raised naming ROADMAP item K before the sp
    axis was ported): JAX's shape, sp = -1 taking the processes dp leaves,
    and rank r at (r // sp, r % sp), never a quiet fall-back to dp."""
    want_sp = 8 // dp if sp == -1 else sp
    for r in range(8):
        mesh = create_mesh(dp=dp, sp=sp, world_size=8, rank=r)
        assert mesh.shape == {DATA_AXIS: dp, SEQ_AXIS: want_sp}
        assert (mesh.dp_rank, mesh.sp_rank) == divmod(r, want_sp)
        assert mesh.group is None and mesh.sp_group is None     # no process group here


def test_use_mesh_restores_state():
    mesh = create_mesh(dp=2, sp=1, world_size=2)
    assert active_mesh() is None
    with use_mesh(mesh) as m:
        assert active_mesh() is mesh and m is mesh
        with use_mesh(None):
            assert active_mesh() is None
        assert active_mesh() is mesh
    assert active_mesh() is None


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_shard_bounds_cover_n(dp):
    """The ranks' pieces are disjoint, in rank order, ceil(n / dp) long but
    for the last ones, and cover [0, n) exactly."""
    for n in range(0, 23):
        seen = []
        for r in range(dp):
            lo, hi = shard_bounds(n, dp, r)
            assert 0 <= lo <= hi <= n and hi - lo <= -(-n // dp)
            seen += range(lo, hi)
        assert seen == list(range(n))


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_flat_shards_layout(dp):
    """Every element of every tensor lands in exactly one rank's shard, at
    the place `pieces` gives it; a shard holds ceil(n_b / dp) of each
    bucket, at most ceil(n / dp) + one padding element a bucket, and the
    padding stays zero."""
    shapes = [(3, 5), (7,), (2, 2, 2), (1,), (11, 3), (4,)]
    tensors = [torch.arange(np.prod(s), dtype=torch.float32).reshape(s) + 100 * i
               for i, s in enumerate(shapes)]
    n = sum(t.numel() for t in tensors)
    owner = {}
    for r in range(dp):
        fs = FlatShards(tensors, Mesh({"dp": dp, "sp": 1}, r), bucket_numel=20)
        assert [b.n for b in fs.buckets] == [15, 7 + 8 + 1, 33, 4]
        assert fs.numel == sum(-(-b.n // dp) for b in fs.buckets)
        assert fs.numel <= -(-n // dp) + len(fs.buckets)
        shard = fs.shard_of(tensors)
        for view, piece in zip(fs.views(tensors), fs.pieces(shard)):
            torch.testing.assert_close(view, piece, rtol=0, atol=0)
        assert float(shard.abs().sum()) == sum(float(v.abs().sum()) for v in fs.views(tensors))
        for k, a, b in fs.spec:
            for e in range(a, b):
                assert (k, e) not in owner
                owner[k, e] = r
    assert len(owner) == n


def _collectives_rank(rank, world, out_dir):
    """Each rank holds its own full-size 'gradients' (rank + 1 times a base)
    and parameters; checks the dp mean, the norm, the all-gathers and
    dp_mean against what every rank can compute alone."""
    shapes = [(5, 3), (13,), (1,), (4, 4), (2,)]
    base = [torch.linspace(-1, 1, int(np.prod(s))).reshape(s) * (i + 1)
            for i, s in enumerate(shapes)]
    mesh = create_mesh(world)
    assert (mesh.rank, mesh.world_size, mesh.group) == (rank, world, torch.distributed.group.WORLD)
    fs = FlatShards([b.clone() for b in base], mesh, bucket_numel=17)
    grads = [(rank + 1) * b for b in base]
    shard = fs.reduce_scatter(grads)
    assert all(g is None for g in grads)          # consumed
    mean = [b * (world + 1) / 2 for b in base]
    for piece, want in zip(fs.pieces(shard), fs.views(mean)):
        torch.testing.assert_close(piece, want, rtol=1e-6, atol=1e-7)
    want_norm = torch.linalg.vector_norm(torch.cat([m.reshape(-1) for m in mean]))
    torch.testing.assert_close(fs.norm(shard), want_norm, rtol=1e-6, atol=0)
    # each rank updates its own elements in place; the gather spreads them
    params = [b.clone() for b in base]
    for v in fs.views(params):
        v.mul_(-2.0)
    fs.gather_into(params)
    for p, b in zip(params, base):
        torch.testing.assert_close(p, -2.0 * b, rtol=0, atol=0)
    full = fs.gather(fs.shard_of(mean))
    for a, b in zip(full, mean):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = sharding.dp_mean({"a": torch.tensor(float(rank)), "b": torch.tensor(2.0)}, mesh)
    assert float(out["a"]) == (world - 1) / 2 and float(out["b"]) == 2.0
    assert sharding.any_rank(rank == world - 1, mesh, "cpu")
    assert not sharding.any_rank(False, mesh, "cpu")
    rows = sharding.all_gather_rows(torch.full((2, 3), float(rank)), mesh)
    assert rows.shape == (2 * world, 3) and rows[::2, 0].tolist() == list(range(world))
    torch.save(dict(sharding.collectives), os.path.join(out_dir, f"calls{rank}.pt"))


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_across_spawned_ranks(world, tmp_path):
    run_ranks(_collectives_rank, world, tmp_path, str(tmp_path))
    calls = torch.load(tmp_path / "calls0.pt")
    # buckets 15 | 13 + 1 | 16 | 2: one reduce-scatter and one all-gather each
    assert calls == {"reduce_scatter": 4, "all_gather": 4 + 4 + 1, "all_reduce": 1 + 1 + 2}


def test_init_distributed_needs_a_rendezvous(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="torchrun"):
        sharding.init_distributed("cpu")
