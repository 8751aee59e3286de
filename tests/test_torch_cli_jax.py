"""Checkpoints across the two packages' command lines, on the CPU: the .npz
archive with its architecture metadata is the format they share.

* ``flowfusion_tpu.cli.main(["train", ...])`` writes a checkpoint that the
  port's ``logprob --trace exact --device cpu`` reads, within the JAX
  package's fused-versus-plain bars of JAX's ``logprob`` of it (its
  ``_restore`` and one jitted solve; bench.py:320-327): equal NFE, mean
  |dlogp| <= 1e-4.  Diffusion and flow; the symplectic family restores
  leaf for leaf (its density draws a momentum, torch's and JAX's differ).
* A port-trained checkpoint restores in JAX's ``_restore``, leaf for leaf,
  and JAX's ``logprob`` of it agrees with the port's at the same bars.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu import cli as jcli
from flowfusion_tpu.utils.data import DEMO_GMM
from flowfusion_tpu.utils.native_loader import write_f32
from flowfusion_torch import cli
from flowfusion_torch.utils.checkpoint import load_npz_leaves

torch.set_num_threads(1)


def _nfe(printed):
    return int(printed.split("rhs_evals=")[1].split()[0])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clijax")
    x = np.asarray(DEMO_GMM.sample(jax.random.PRNGKey(0), 300), np.float32)
    path = str(tmp / "x.f32")
    write_f32(path, x)
    return tmp, path, x


def _jax_restore(ckpt):
    return jcli._restore(argparse.Namespace(ckpt=ckpt))


def _port_logprob(tmp, ckpt, path, capsys):
    """The port's `logprob --trace exact --device cpu`: (densities, NFE)."""
    out = str(tmp / "lp_port.npy")
    capsys.readouterr()
    cli.main(["logprob", "--ckpt", ckpt, "--data", path, "--tol", "1e-5", "--trace", "exact", "--out", out,
              "--device", "cpu"])
    return np.load(out), _nfe(capsys.readouterr().out)


def _jax_logprob(ckpt, x):
    """JAX's `logprob` of the checkpoint as one solve: its `_restore`, then
    the model's log_prob under jax.jit at the CLI's tolerance (an eager call
    would autoshard over the test mesh and step each shard on its own)."""
    jm, _ = _jax_restore(ckpt)
    key = jax.random.PRNGKey(0)
    lp, st = jax.jit(lambda m, xx: m.log_prob(xx, key=key, atol=1e-5, rtol=1e-5))(jm, jnp.asarray(x))
    return np.asarray(lp), int(st.n_func_evals)


def _same_leaves(jmodel, ckpt):
    leaves = load_npz_leaves(ckpt)
    flat, _ = jax.tree_util.tree_flatten_with_path(jmodel)
    assert len(flat) == len(leaves)
    for (_, leaf), (name, arr) in zip(flat, leaves.items()):
        assert np.array_equal(np.asarray(leaf), arr), name


@pytest.mark.parametrize("family", ["diffusion", "flow"])
def test_jax_trained_checkpoint_serves_in_the_port(data, capsys, family):
    tmp, path, x = data
    ckpt = str(tmp / f"jax_{family}.npz")
    jcli.main(["train", "--data", path, "--dim", "2", "--units", "16", "16", "--stages", "64:1e-3",
               "--epochs", "2", "--family", family, "--out", ckpt])
    tlp, tnfe = _port_logprob(tmp, ckpt, path, capsys)
    jlp, jnfe = _jax_logprob(ckpt, x)
    assert tnfe == jnfe
    assert float(np.mean(np.abs(tlp - jlp))) <= 1e-4


def test_jax_trained_symplectic_checkpoint_restores_in_the_port(data):
    """The port restores a JAX symplectic CLI checkpoint leaf for leaf (its
    log_prob draws a momentum, which torch and JAX draw differently)."""
    tmp, path, x = data
    ckpt = str(tmp / "jax_symplectic.npz")
    jcli.main(["train", "--data", path, "--dim", "2", "--units", "16", "16", "--stages", "64:1e-3",
               "--epochs", "2", "--family", "symplectic", "--out", ckpt])
    model, meta = cli._restore(argparse.Namespace(ckpt=ckpt, trace=None, device="cpu"))
    assert meta["family"] == "symplectic"
    jm, _ = _jax_restore(ckpt)
    assert np.array_equal(np.asarray(jm.params["q_layers"][0]["w"]), model.params["q_layers"][0]["w"].numpy())
    assert np.array_equal(np.asarray(jm.scale), model.scale.numpy())


def test_port_trained_checkpoint_restores_in_jax(data, capsys):
    tmp, path, x = data
    ckpt = str(tmp / "port.npz")
    cli.main(["train", "--data", path, "--dim", "2", "--units", "16", "16", "--stages", "64:1e-3", "--epochs", "2",
              "--out", ckpt, "--device", "cpu"])
    jmodel, meta = _jax_restore(ckpt)
    assert meta["family"] == "diffusion" and meta["units"] == [16, 16]
    _same_leaves(jmodel, ckpt)
    tlp, tnfe = _port_logprob(tmp, ckpt, path, capsys)
    jlp, jnfe = _jax_logprob(ckpt, x)
    assert tnfe == jnfe
    assert float(np.mean(np.abs(tlp - jlp))) <= 1e-4
