"""The port's ``parallel.distributed`` and batch-global ``data_parallel`` on
a real two-process ``gloo`` cluster on the CPU.

The workers are subprocesses running this file's ``__main__`` block (they
import the port only): each initializes the process group with explicit
arguments, takes its rows of a global batch with ``local_rows`` and
``global_batch_from_local`` and runs, under ``data_parallel``:

  * the flagship ``log_prob`` on 64 rows, exact and Hutchinson (the global
    probe's rows): the adaptive error norm is summed over both processes
    every attempt, so the NFE equals the single-process solve's and the
    densities agree within 1e-5 with the port's single-process solve, and
    the split adds at most 1e-5 to that solve's gap from the JAX package's
    jitted (unrouted) solve of the same rows;
  * the DSM loss on the global draw's rows and its gradients: every rank's
    gradients are the single-process gradients of the global batch within
    1e-5;
  * ``sample_sde`` with a NaN in one process's rows: both processes freeze;
  * ``fit`` with a shared ``checkpoint_dir``: rank 0 alone writes; then with
    a process-local directory on rank 1, and with none on rank 1, both ranks
    raise before any step.

A free port, a per-call timeout and one retry on a rendezvous timeout, as
``tests/test_distributed_multiprocess.py`` does.
"""

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "benchmarks", "flagship_ckpt.npz")
N_GLOBAL = 64


def _worker(rank: int, world: int, port: str, inputs_path: str, outdir: str) -> None:
    import torch

    from flowfusion_torch import train as train_lib
    from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops import losses
    from flowfusion_torch.ops.integrate import euler_maruyama
    from flowfusion_torch.ops.sde import VESDE
    from flowfusion_torch.parallel import (
        data_parallel, global_batch_from_local, initialize_distributed, local_rows, make_mesh,
    )
    from flowfusion_torch.utils.checkpoint import load_npz
    from flowfusion_torch.utils.convert import params_from_numpy

    torch.set_num_threads(1)
    got = initialize_distributed(f"localhost:{port}", world, rank, backend="gloo", timeout=120)
    assert got == rank and initialize_distributed() == rank
    inputs = np.load(inputs_path)
    start, stop = local_rows(N_GLOBAL)
    assert (start, stop) == (rank * N_GLOBAL // world, (rank + 1) * N_GLOBAL // world)
    mesh = make_mesh(["cpu"])
    mine = {k: torch.as_tensor(inputs[k][start:stop]) for k in ("x", "e", "t", "z")}
    b = global_batch_from_local(mine, mesh)

    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    flag = ScoreModel(params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu"), cfg, VESDE())
    out = {}
    for mode in ("exact", "hutchinson"):
        m = flag if mode == "exact" else ScoreModel(flag.params, cfg, VESDE(), trace_mode="hutchinson")
        probes = () if mode == "exact" else (b["e"],)
        lp, st = data_parallel(lambda bb: m.log_prob(bb["x"], probes=probes), mesh)(b)
        out[f"lp_{mode}"], out[f"nfe_{mode}"] = lp.numpy(), st.n_func_evals

    # the DSM loss on the global draw's rows, through the model's loss_fn
    losses._draw_t_and_z = lambda g, sde, xx: (b["t"], b["z"])
    params = [flag.params["W"]] + [p for layer in flag.params["layers"] for p in (layer["w"], layer["b"])]
    for p in params:
        p.requires_grad_(True)

    def grads_fn(bb):
        loss = flag.loss_fn(None, bb["x"])
        return loss, torch.autograd.grad(loss, params)

    loss, grads = data_parallel(grads_fn, mesh)(b)
    out["loss"] = loss.detach().numpy()
    for i, g in enumerate(grads):
        out[f"g{i}"] = g.numpy()
    for p in params:
        p.requires_grad_(False)

    # the EM NaN freeze is batch-global: a NaN row on rank 1 only freezes
    # rank 0's rows at step 0 too
    x0 = b["x"].clone()
    if rank == 1:
        x0[0, 0] = float("nan")
    res = data_parallel(lambda xx: euler_maruyama(
        None, lambda t, x: -x, lambda t, x: torch.ones_like(x), xx, t0=1.0, t1=0.0, steps=4,
        noise=torch.zeros((4,) + tuple(xx.shape))), mesh)(x0)
    out["em_frozen"], out["em_x"], out["em_x0"] = bool(res.nan_encountered), res.x.numpy(), x0.numpy()

    # fit: rank 0 alone writes the snapshot of a shared checkpoint_dir
    writes, steps = [], []
    save = train_lib.save_npz
    train_lib.save_npz = lambda *a, **k: (writes.append(1), save(*a, **k))

    def counted_loss(model, g, x, c):
        steps.append(1)
        return model.loss_fn(g, x, c)

    small_cfg = ScoreMLPConfig(n_dimensions=2, units=(16,))
    small = ScoreModel(init_score_mlp(small_cfg, torch.Generator().manual_seed(0), "cpu"), small_cfg, VESDE())
    x_fit = torch.as_tensor(inputs["x"])
    shared = os.path.join(outdir, "shared_ckpt")
    kw = dict(stages=[(32, 1e-3)], epochs_per_stage=3, engine="plain", loss_fn=counted_loss)
    train_lib.fit(small, torch.Generator().manual_seed(1), x_fit, checkpoint_dir=shared, max_epochs_total=1, **kw)
    out["writes"], out["steps"] = len(writes), len(steps)
    # rank 1 on a directory of its own would start at epoch 0 while rank 0
    # resumes at epoch 1: both raise before any step
    local = shared if rank == 0 else os.path.join(outdir, "rank1_ckpt")
    del steps[:]
    try:
        train_lib.fit(small, torch.Generator().manual_seed(1), x_fit, checkpoint_dir=local, **kw)
        out["raised"] = ""
    except RuntimeError as err:
        out["raised"] = str(err)
    out["steps_after_split"] = len(steps)
    # rank 1 with no checkpoint_dir at all takes part in the agreement at
    # (0, 0): both raise, and neither waits in the gather for the other
    try:
        train_lib.fit(small, torch.Generator().manual_seed(1), x_fit, checkpoint_dir=shared if rank == 0 else None,
                      **kw)
        out["raised_none"] = ""
    except RuntimeError as err:
        out["raised_none"] = str(err)
    out["steps_after_none"] = len(steps)
    np.savez(os.path.join(outdir, f"worker{rank}.npz"), **out)
    print(f"worker {rank}: OK", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cluster(inputs_path, outdir, world: int = 2, timeout: int = 240, _retry: bool = True):
    import pytest

    outdir = os.path.join(str(outdir), "retry" if not _retry else "first")
    os.makedirs(outdir)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), inputs_path, outdir],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    outs, timed_out = [], False
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        timed_out = True
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
    starved = timed_out or any(
        p.returncode != 0 and ("Timed out" in o or "timeout" in o.lower() and "rendezvous" in o.lower())
        for p, o in zip(procs, outs)
    )
    if starved and _retry:
        return _run_cluster(inputs_path, os.path.dirname(outdir), world, timeout, _retry=False)
    if timed_out:
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"worker {r}: OK" in o, f"worker {r} (rc={p.returncode}):\n{o}"
    return [dict(np.load(os.path.join(outdir, f"worker{r}.npz"))) for r in range(world)]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
else:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import pytest
    import torch
    import torch.distributed as dist

    from flowfusion_tpu.models import nets as jnets
    from flowfusion_tpu.models.score import ScoreModel as JScoreModel
    from flowfusion_tpu.ops import trace as jtrace
    from flowfusion_tpu.ops.sde import VESDE as JVESDE
    from flowfusion_tpu.utils import checkpoint as jckpt
    from flowfusion_torch.models.nets import ScoreMLPConfig
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops import losses
    from flowfusion_torch.ops.sde import VESDE
    from flowfusion_torch.parallel import (
        data_parallel, global_batch_from_local, initialize_distributed, local_rows, make_mesh, shard_batch,
    )
    from flowfusion_torch.utils.checkpoint import load_npz
    from flowfusion_torch.utils.convert import params_from_numpy

    torch.set_num_threads(1)
    KEY = jax.random.PRNGKey(7)

    def _flagship():
        cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
        return ScoreModel(params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu"), cfg, VESDE())

    @pytest.fixture(scope="module")
    def cluster(tmp_path_factory):
        """The inputs (numpy seed; the probe is the JAX package's draw for
        KEY, so the JAX solve sees the same rows) and both workers' results."""
        tmp = tmp_path_factory.mktemp("torch_cluster")
        rng = np.random.default_rng(0)
        x = rng.standard_normal((N_GLOBAL, 2)).astype(np.float32)
        e = np.asarray(jtrace.make_probes("hutchinson", KEY, jnp.asarray(x))[0])
        sde = VESDE()
        t = rng.uniform(sde.epsilon, sde.T, N_GLOBAL).astype(np.float32)
        z = rng.standard_normal((N_GLOBAL, 2)).astype(np.float32)
        inputs = dict(x=x, e=e, t=t, z=z)
        path = str(tmp / "inputs.npz")
        np.savez(path, **inputs)
        return inputs, _run_cluster(path, tmp)

    def test_initialize_distributed_single_process_is_a_noop(monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        assert initialize_distributed() == 0
        assert not dist.is_initialized()

    def test_local_rows_and_global_batch_single_process(monkeypatch):
        assert local_rows(64) == (0, 64)
        from flowfusion_torch.parallel import distributed

        with monkeypatch.context() as mp:  # rank 1 of a world of two
            mp.setattr(distributed, "_world", lambda: (2, 1))
            assert local_rows(64) == (32, 64)
            with pytest.raises(ValueError, match="pad_to_multiple"):
                local_rows(63)
        mesh = make_mesh(["cpu"])
        x = torch.arange(12.0).reshape(6, 2)
        s = torch.tensor(3.0)
        got = global_batch_from_local({"x": x, "s": s}, mesh)
        (one,) = shard_batch({"x": x, "s": s}, mesh)
        assert torch.equal(got["x"], one["x"]) and got["s"] is s and one["s"] is s
        with pytest.raises(ValueError, match="shard_batch"):
            global_batch_from_local(x, make_mesh(["cpu", "cpu"]))

    def test_data_parallel_without_a_group_is_fn():
        """No process group: ``data_parallel`` is ``fn`` on the batch,
        bitwise; a mesh of two devices is refused with torch's idiom."""
        m = dataclasses.replace(_flagship(), trace_mode="hutchinson")
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((16, 2)).astype(np.float32))
        e = torch.sign(torch.as_tensor(np.random.default_rng(2).standard_normal((16, 2)).astype(np.float32)))
        lp, st = m.log_prob(x, probes=(e,))
        lp_dp, st_dp = data_parallel(lambda b: m.log_prob(b, probes=(e,)), make_mesh(["cpu"]))(x)
        assert torch.equal(lp, lp_dp) and st == st_dp
        with pytest.raises(ValueError, match="data_parallel_per_shard.*torchrun|torchrun.*data_parallel_per_shard"):
            data_parallel(lambda b: b, make_mesh(["cpu", "cpu"]))

    @pytest.mark.parametrize("mode", ["exact", "hutchinson"])
    def test_data_parallel_log_prob_matches_single_process_and_jax(cluster, mode):
        """Batch-global stepping across two processes: each process's NFE
        is the single-process solve's (the port's and the JAX package's
        jitted solve of the 64 rows), the densities within 1e-5 of both."""
        inputs, ranks = cluster
        x = inputs["x"]
        lp2 = np.concatenate([r[f"lp_{mode}"] for r in ranks])
        nfe2 = [int(r[f"nfe_{mode}"]) for r in ranks]
        m = dataclasses.replace(_flagship(), trace_mode=mode)
        probes = () if mode == "exact" else (torch.as_tensor(inputs["e"]),)
        lp1, st1 = m.log_prob(torch.as_tensor(x), probes=probes)
        jcfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
        jm = jckpt.load_npz(FLAGSHIP, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), jcfg),
                                                  net=jcfg, sde=JVESDE()))
        jm = dataclasses.replace(jm, trace_mode=mode, use_fused_kernel=False)
        jlp, jst = jax.jit(lambda mm, xx: mm.log_prob(xx, key=KEY))(jm, jnp.asarray(x))
        assert nfe2 == [st1.n_func_evals] * 2 == [int(jst.n_func_evals)] * 2
        np.testing.assert_allclose(lp2, lp1.numpy(), rtol=0, atol=1e-5)
        # the port's single-process solve is itself up to ~5e-5 from the
        # JAX solve on these rows (the parity bar of test_torch_score.py:
        # mean 1e-4, max 1e-3); the split over two processes adds at most
        # 1e-5 to that gap
        gap1 = np.abs(lp1.numpy() - np.asarray(jlp))
        assert gap1.mean() <= 1e-4 and gap1.max() <= 1e-3
        assert np.all(np.abs(lp2 - np.asarray(jlp)) <= gap1 + 1e-5)

    def test_dsm_gradients_match_single_process(cluster, monkeypatch):
        """The DSM loss of the global batch on every rank, and every rank's
        gradients the single-process gradients within 1e-5."""
        inputs, ranks = cluster
        monkeypatch.setattr(losses, "_draw_t_and_z",
                            lambda g, sde, xx: (torch.as_tensor(inputs["t"]), torch.as_tensor(inputs["z"])))
        m = _flagship()
        params = [m.params["W"]] + [p for layer in m.params["layers"] for p in (layer["w"], layer["b"])]
        for p in params:
            p.requires_grad_(True)
        loss = m.loss_fn(None, torch.as_tensor(inputs["x"]))
        grads = torch.autograd.grad(loss, params)
        for r in ranks:
            np.testing.assert_allclose(r["loss"], float(loss.detach()), rtol=1e-5)
            for i, g in enumerate(grads):
                np.testing.assert_allclose(r[f"g{i}"], g.numpy(), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("path", ["dsm", "likelihood_weighted", "flow_matching", "sample_pc", "em_freeze"])
    def test_group_reductions_stay_on_the_values_device(monkeypatch, path):
        """Every all-reduce of the loss and sampling paths is given a
        tensor on the device of the values it reduces: an NCCL group has
        no backend for CPU tensors.  A stand-in for such a group (world 2)
        refuses CPU tensors; the values lie on the meta device in place of
        the card, so a count or flag made on the host fails the call."""
        from flowfusion_torch.models.nets import init_score_mlp
        from flowfusion_torch.ops.integrate import euler_maruyama
        from flowfusion_torch.parallel import _collective

        reduced = []

        def nccl_like_all_reduce(t, op=None, group=None):
            if t.device.type == "cpu":
                raise RuntimeError("No backend type associated with device type cpu")
            reduced.append(t.device.type)

        monkeypatch.setattr(dist, "all_reduce", nccl_like_all_reduce)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        cfg = ScoreMLPConfig(n_dimensions=2, units=(16, 16))
        p = init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
        params = {"W": p["W"].to("meta"), "layers": [{k: v.to("meta") for k, v in l.items()} for l in p["layers"]]}
        m = ScoreModel(params, cfg, VESDE())
        x = torch.zeros(8, 2, device="meta")
        w = params["W"].requires_grad_(path not in ("sample_pc", "em_freeze"))
        group = object()
        with _collective.activate(group):
            if path == "dsm":
                out = m.loss_fn(None, x)
            elif path == "likelihood_weighted":
                out = losses.log_prob_score_matching(m.score, m.sde, None, x)
            elif path == "flow_matching":
                v = _collective.replicated(w, group)
                out = losses.flow_matching_loss(lambda t, xx, c: xx * v[0], None, x)
            elif path == "sample_pc":
                out = m.sample_pc((8, 2), steps=2).x
            else:
                out = euler_maruyama(None, lambda t, xx: -xx, lambda t, xx: torch.ones_like(xx), x, t0=1.0, t1=0.0,
                                     steps=2).x
            if w.requires_grad:
                (g,) = torch.autograd.grad(out, [w])
                assert g.device.type == "meta"
        assert out.device.type == "meta" and reduced and set(reduced) == {"meta"}

    def test_em_freeze_is_batch_global(cluster):
        """A NaN row on rank 1 freezes rank 0's rows at step 0 too."""
        _, ranks = cluster
        for r in ranks:
            assert bool(r["em_frozen"])
        np.testing.assert_array_equal(ranks[0]["em_x"], ranks[0]["em_x0"])

    def test_fit_snapshots_rank0_and_split_resume_raises(cluster):
        _, ranks = cluster
        assert int(ranks[0]["writes"]) >= 1 and int(ranks[1]["writes"]) == 0
        assert int(ranks[0]["steps"]) > 0 and int(ranks[0]["steps"]) == int(ranks[1]["steps"])
        for r in ranks:
            assert "resume position disagrees" in str(r["raised"]), r["raised"]
            assert int(r["steps_after_split"]) == 0
            assert "resume position disagrees" in str(r["raised_none"]), r["raised_none"]
            assert int(r["steps_after_none"]) == 0
