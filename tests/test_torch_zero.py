"""The ZeRO-2 trainer (`AccumulatingAdamW(mesh=)`, `Trainer(mesh=)`) on two
and three spawned `gloo` processes on the CPU, at TINY_MODEL_CONFIG size in
fp32, against the one-process trainer on the concatenated batch with the
same `Draws`, and against the JAX package's `make_train_step`.

Each rank takes its rows of a global batch of 6 clips (3 a rank at dp 2, 2
at dp 3) and of the draws; the optimizer's buckets are cut small
(`BUCKET`) so that the layout has several buckets and padding. JAX's own
dp tests are slow, and its dp is partitioning-invariant, so its
single-device step is the oracle. Tolerances: parameters, EMA, AdamW
moments, loss and grad_norm at a relative 1e-5 against the one-process port
(fp32, summation order); against JAX, test_torch_train.py's: loss and
parameters 1e-5, gradient quantities (grad_norm, the first moment) 1e-4.

The learning rate is the shipped configs' 1e-5. AdamW divides each element's
step by that element's own gradient scale, so an element whose gradient is
near its rounding noise (most of the tiny random UNet's are below 1e-8,
where Adam's eps sits) moves by an amount the summation order decides: at
lr 1e-3 that noise alone is 3e-5 of the parameters' norm. The moments are
linear (and quadratic) in the gradient and hold the update's inputs to
1e-5 whatever the rate.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402  (a plain dict)
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.parallel import sharding  # noqa: E402
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.training import trainer as ttrainer  # noqa: E402
from test_torch_parallel import few_torch_threads, run_ranks  # noqa: E402,F401

B, T, HW = 6, 4, 16     # global clips, frames, frame size
STEPS = 4               # micro-steps: two windows of accumulation 2
BUCKET = 1 << 18        # fp32 elements an optimizer bucket here
WHAT = ("params", "ema", "exp_avg", "exp_avg_sq")
CFGS = {
    "ema": dict(learning_rate=1e-5, accumulate_grad_batches=2, use_ema=True, ema_decay=0.9,
                uncond_prob=0.3),
    "logvar": dict(learning_rate=1e-5, accumulate_grad_batches=2, use_ema=True, ema_decay=0.9,
                   uncond_prob=0.3, learn_logvar=True, logvar_init=0.1),
}


def rel(a, b):
    """Relative L2 of a against b, each a tensor or a dict of tensors."""
    if isinstance(a, dict):
        a, b = (torch.cat([x[k].detach().double().reshape(-1) for k in sorted(b)])
                for x in (a, b))
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _pipe(weights=None):
    pipe = DynamiCrafterPipeline.for_training(ModelConfig(TINY_MODEL_CONFIG), "cpu",
                                              frozen_dtype=torch.float32)
    if weights is None:
        pipe.init_random(seed=5)
    else:
        pipe.load_state_dict(weights)
    return pipe


def _trainer(pipe, cfg, mesh=None):
    trainer = ttrainer.Trainer(pipe, cfg, mesh=mesh)
    if mesh is not None:
        trainer.opt = ttrainer.AccumulatingAdamW(trainer.params, cfg, mesh=mesh,
                                                 bucket_numel=BUCKET)
    return trainer


def rows(batch, draws, rank, world):
    """This rank's clips of a global batch and its draws (cond_idx is one
    frame for the whole batch, as in JAX)."""
    b = batch["video"].shape[0]
    lo, hi = rank * b // world, (rank + 1) * b // world
    t = batch["video"].shape[1]
    part = {k: v[lo:hi] for k, v in batch.items()}
    d = draws._replace(t=draws.t[lo:hi], noise=draws.noise[lo:hi],
                       enc_noise=draws.enc_noise[lo * t:hi * t], uniform=draws.uniform[lo:hi],
                       offset=None if draws.offset is None else draws.offset[lo:hi])
    return part, d


def _inputs(pipe, trainer, seed=0):
    """STEPS global batches and their draws, from seeds."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        batch = {"video": torch.from_numpy(
                     rng.uniform(-1, 1, (B, T, HW, HW, 3)).astype(np.float32)),
                 "tokens": torch.as_tensor(np.asarray(pipe.tokenizer(
                     [f"clip {i} {j}" for j in range(B)])), dtype=torch.long),
                 "fs": torch.from_numpy(rng.integers(1, 8, B))}
        out.append((batch, trainer.draw(batch, torch.Generator().manual_seed(100 + i))))
    return out


def _from_state(state):
    """Parameters, EMA and AdamW moments by name, from a state_dict."""
    names, moments = list(state["weights"]), state["optimizer"]["state"]
    return {"params": {k: v.detach().clone() for k, v in state["weights"].items()},
            "ema": {k: v.clone() for k, v in state["ema"].items()},
            **{m: {k: moments[i][m].clone() for i, k in enumerate(names)}
               for m in ("exp_avg", "exp_avg_sq")}}


def _record(trainer):
    """Parameters, EMA and AdamW moments by name. With a mesh, on every
    rank: every rank calls state_dict (rank 0 alone gets the state), then
    gathers the shards itself; `state` says whether this rank got a state
    and whether it equals the gathered tensors bit for bit."""
    if trainer.mesh is None:
        return _from_state(trainer.state_dict())
    state = trainer.state_dict()
    opt = trainer.opt
    full = lambda x: dict(zip(trainer.params, opt.shards.gather(x)))
    rec = {"params": {k: p.detach().clone() for k, p in trainer.params.items()},
           "ema": full(opt.ema), "exp_avg": full(opt.exp_avg), "exp_avg_sq": full(opt.exp_avg_sq)}
    got = None if state is None else _from_state(state)
    rec["state"] = None if got is None else all(
        torch.equal(got[what][k], rec[what][k]) for what in got for k in got[what])
    return rec


def _zero_rank(rank, world, job_path, out_dir):
    """Runs on each rank: STEPS micro-steps from the shared start on this
    rank's rows; the EMA and parameters after each window, the layout's
    sizes, a checkpoint after micro-step 3 and, given one, a resume from a
    one-process checkpoint for the last micro-step."""
    job = torch.load(job_path, weights_only=False)
    cfg = ttrainer.TrainConfig(**job["cfg"])
    mesh = sharding.create_mesh(world)
    pipe = _pipe()
    trainer = _trainer(pipe, cfg, mesh)
    out = {"metrics": []}
    for i, (batch, draws) in enumerate(job["inputs"]):
        m = trainer.train_step(*rows(batch, draws, rank, world))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        step = i + 1
        if step == 3:
            opt = trainer.opt
            out["sizes"] = dict(n=sum(p.numel() for p in trainer.params.values()),
                                buckets=[b.n for b in opt.shards.buckets], shard=opt.shards.numel,
                                own=sum(b - a for _, a, b in opt.shards.spec),
                                exp_avg=opt.exp_avg.numel(),
                                exp_avg_sq=opt.exp_avg_sq.numel(), ema=opt.ema.numel(),
                                acc=opt._acc.numel())
            state = trainer.state_dict()
            if rank == 0:
                torch.save(state, os.path.join(out_dir, f"dp{world}_step3.pt"))
            out["step3_state"] = state is not None
        if step % 2 == 0:
            out[step] = _record(trainer)
    if job.get("resume"):
        resumed = _trainer(pipe, cfg, mesh)
        resumed.load_state_dict(torch.load(job["resume"], weights_only=True))
        m = resumed.train_step(*rows(*job["inputs"][3], rank, world))
        out["resumed"] = dict(_record(resumed), metrics={k: float(v) for k, v in m.items()},
                              step=resumed.step)
    torch.save(out, os.path.join(out_dir, f"{job['name']}_rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs (and their checkpoint after micro-step 3), the
    dp 2 run of the "ema" config with a resume from that checkpoint, the dp
    3 run of the "logvar" config, and a one-process resume from the dp 2
    checkpoint."""
    root = tmp_path_factory.mktemp("zero")
    plain = {}
    for name, kw in CFGS.items():
        cfg = ttrainer.TrainConfig(**kw)
        trainer = _trainer(_pipe(), cfg)
        inputs = _inputs(trainer.pipe, trainer)
        rec = {"metrics": [], "inputs": inputs}
        for i, (batch, draws) in enumerate(inputs):
            m = trainer.train_step(batch, draws)
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            if i + 1 == 3:
                torch.save(trainer.state_dict(), root / f"{name}_plain_step3.pt")
            if (i + 1) % 2 == 0:
                rec[i + 1] = _record(trainer)
        plain[name] = rec
    dist = {}
    for name, world in (("ema", 2), ("logvar", 3)):
        job = {"name": name, "cfg": CFGS[name], "inputs": plain[name]["inputs"],
               "resume": str(root / f"{name}_plain_step3.pt") if world == 2 else None}
        torch.save(job, root / f"{name}_job.pt")
        run_ranks(_zero_rank, world, root, str(root / f"{name}_job.pt"), str(root))
        dist[name] = [torch.load(root / f"{name}_rank{r}.pt", weights_only=False)
                      for r in range(world)]
    # the dp 2 checkpoint resumed in one process
    cfg = ttrainer.TrainConfig(**CFGS["ema"])
    resumed = _trainer(_pipe(), cfg)
    resumed.load_state_dict(torch.load(root / "dp2_step3.pt", weights_only=True))
    m = resumed.train_step(*plain["ema"]["inputs"][3])
    one = dict(_record(resumed), metrics={k: float(v) for k, v in m.items()}, step=resumed.step)
    return plain, dist, one


@pytest.mark.parametrize("name,world", [("ema", 2), ("logvar", 3)])
def test_dp_steps_equal_the_one_process_trainer(runs, name, world):
    """Parameters, EMA and moments after each accumulation window, and
    every micro-step's losses and grad_norm, on every rank."""
    plain, dist, _ = runs
    want = plain[name]
    got = dist[name]
    for r, out in enumerate(got):
        for step, (m, w) in enumerate(zip(out["metrics"], want["metrics"])):
            assert set(m) == set(w)
            for k in w:
                assert abs(m[k] - w[k]) <= 1e-5 * abs(w[k]) + 1e-12, (r, step, k, m[k], w[k])
        for step in (2, 4):
            for what in WHAT:
                assert rel(out[step][what], want[step][what]) <= 1e-5, (r, step, what)
    if name == "logvar":
        moved = got[0][4]["params"]["logvar"] - torch.full_like(got[0][4]["params"]["logvar"], 0.1)
        assert float(moved.abs().max()) > 0       # the table rides in the buckets and trains


@pytest.mark.parametrize("name,world", [("ema", 2), ("logvar", 3)])
def test_each_rank_holds_a_dp_th_of_the_state(runs, name, world):
    """Moments, EMA and accumulator are shard-sized: ceil(n_b / dp) a bucket,
    at most ceil(n / dp) plus one padding element a bucket; the ranks' own
    elements add up to n."""
    _, dist, _ = runs
    sizes = [out["sizes"] for out in dist[name]]
    n = sizes[0]["n"]
    assert sum(sizes[0]["buckets"]) == n and len(sizes[0]["buckets"]) > 1
    assert sum(s["own"] for s in sizes) == n
    for s in sizes:
        want = sum(-(-b // world) for b in s["buckets"])
        assert s["shard"] == want <= -(-n // world) + len(s["buckets"])
        assert s["exp_avg"] == s["exp_avg_sq"] == s["ema"] == s["acc"] == want


@pytest.mark.parametrize("name,world", [("ema", 2), ("logvar", 3)])
def test_state_dict_is_built_on_rank_0_alone(runs, name, world):
    """Every rank makes state_dict's all-gathers; rank 0 alone copies the
    full tensors to the host, and they equal what each rank gathers bit for
    bit; the other ranks get None."""
    _, dist, _ = runs
    for r, out in enumerate(dist[name]):
        assert out["step3_state"] == (r == 0), r
        for step in (2, 4):
            assert out[step]["state"] == (True if r == 0 else None), (r, step)


def test_checkpoint_dp2_resumes_in_one_process(runs):
    """A dp 2 checkpoint (full tensors, the one-process format) loads into
    the one-process trainer, whose next micro-step equals the uninterrupted
    run's."""
    plain, _, one = runs
    want = plain["ema"]
    assert one["step"] == 4
    for k, w in want["metrics"][3].items():
        assert abs(one["metrics"][k] - w) <= 1e-5 * abs(w), k
    for what in WHAT:
        assert rel(one[what], want[4][what]) <= 1e-5, what


def test_checkpoint_one_process_resumes_at_dp2(runs):
    plain, dist, _ = runs
    want = plain["ema"]
    for out in dist["ema"]:
        got = out["resumed"]
        assert got["step"] == 4
        for k, w in want["metrics"][3].items():
            assert abs(got["metrics"][k] - w) <= 1e-5 * abs(w), k
        for what in WHAT:
            assert rel(got[what], want[4][what]) <= 1e-5, what


def test_world_size_one_is_the_plain_trainer_bit_for_bit(tmp_path):
    """At dp 1 (one gloo process) the ZeRO path gives the plain trainer's
    parameters, EMA and moments bit for bit; only grad_norm's summation
    order differs."""
    run_ranks(_world_one_rank, 1, tmp_path, str(tmp_path))
    got = torch.load(tmp_path / "world1.pt", weights_only=False)
    assert got["max_diff"] == 0.0, got
    assert got["grad_norm_rel"] <= 1e-5


def _world_one_rank(rank, world, out_dir):
    cfg = ttrainer.TrainConfig(**CFGS["logvar"])
    plain = _trainer(_pipe(), cfg)
    zero = _trainer(_pipe(), cfg, sharding.create_mesh(1))
    diffs, norms = [], []
    for batch, draws in _inputs(plain.pipe, plain)[:2]:
        a, b = plain.train_step(batch, draws), zero.train_step(batch, draws)
        norms.append(abs(float(a["grad_norm"]) / float(b["grad_norm"]) - 1))
    sa, sb = plain.state_dict(), zero.state_dict()
    for k in plain.params:
        diffs.append(float((sa["weights"][k] - sb["weights"][k]).abs().max()))
        diffs.append(float((sa["ema"][k] - sb["ema"][k]).abs().max()))
    for i, st in sa["optimizer"]["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            diffs.append(float((st[name] - sb["optimizer"]["state"][i][name]).abs().max()))
    assert sa["optimizer"]["param_groups"] == sb["optimizer"]["param_groups"]
    torch.save({"max_diff": max(diffs), "grad_norm_rel": max(norms)},
               os.path.join(out_dir, "world1.pt"))


def _jax_rank(rank, world, job_path, out_dir):
    job = torch.load(job_path, weights_only=False)
    cfg = ttrainer.TrainConfig(**job["cfg"])
    trainer = _trainer(_pipe(job["weights"]), cfg, sharding.create_mesh(world))
    metrics = []
    for batch, draws in job["inputs"]:
        m = trainer.train_step(*rows(batch, draws, rank, world))
        metrics.append({k: float(v) for k, v in m.items()})
    rec = _record(trainer)
    if rank == 0:
        torch.save(dict(rec, metrics=metrics), os.path.join(out_dir, "jax_dp2.pt"))


def test_dp2_step_matches_the_jax_train_step(tmp_path):
    """Two steps without accumulation (the window of the tests above costs
    the JAX compile another 20 s; the port's k = 1 branch is covered here),
    EMA on, at dp 2 from the JAX pipeline's random weights and JAX's own
    draws, against jax.jit(make_train_step) on one device over the 2-clip
    batch: losses, parameters and EMA to 1e-5; grad_norm and AdamW's first
    moment (a running mean of the clipped gradients) to 1e-4."""
    jax = pytest.importorskip("jax")
    from dynamicrafter_tpu.training import trainer as jtrainer
    from dynamicrafter_tpu.utils.export import export_state_dict
    from test_torch_train import _batch, _jax_draws, _split, _torch_batch, build_pipes

    jp, tp = build_pipes()
    kw = dict(CFGS["ema"], accumulate_grad_batches=1)
    jcfg = jtrainer.TrainConfig(remat=False, **kw)
    frozen, trainable = _split(jp.params)
    state, tx = jtrainer.create_train_state(trainable, jcfg)
    step = jax.jit(jtrainer.make_train_step(jp, jcfg, tx))
    rng = jax.random.PRNGKey(7)
    inputs, j_metrics = [], []
    for i in range(2):
        batch = _batch(jp, seed=i)
        _, draws = _jax_draws(jax.random.fold_in(rng, i), jp, jcfg)
        inputs.append((_torch_batch(batch), draws))
        state, m = step(state, frozen, batch, rng)
        j_metrics.append({k: float(v) for k, v in m.items()})
    u = jp.unet_config
    adam = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda s: hasattr(
        s, "mu")) if hasattr(s, "mu")]
    ref = {"params": export_state_dict(state.params, unet_config=u),
           "ema": export_state_dict(state.ema_params, unet_config=u),
           "exp_avg": export_state_dict(adam[0].mu, unet_config=u)}
    weights = {k: v.detach().clone() for k, v in tp.net.state_dict().items()}
    torch.save({"cfg": kw, "inputs": inputs, "weights": weights}, tmp_path / "job.pt")
    run_ranks(_jax_rank, 2, tmp_path, str(tmp_path / "job.pt"), str(tmp_path))
    got = torch.load(tmp_path / "jax_dp2.pt", weights_only=False)
    for m, w in zip(got["metrics"], j_metrics):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=1e-4)
    keys = sorted(got["params"])
    assert len(adam) == 1 and set(keys) <= set(ref["params"])
    for what, tol in (("params", 1e-5), ("ema", 1e-5), ("exp_avg", 1e-4)):
        want = {k: torch.from_numpy(np.array(ref[what][k])) for k in keys}
        assert rel(got[what], want) <= tol, (what, rel(got[what], want))
