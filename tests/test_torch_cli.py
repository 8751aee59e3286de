"""The port's command line (``python -m flowfusion_torch``) on the CPU
(``--device cpu``): train -> sample -> logprob -> export round trips for the
three families, and the cases of the JAX package's tests/test_cli.py:155-306
that have a meaning in the port: flag validation, ``--buckets`` validation,
export refusals translated to CLI advice, resume through
``--checkpoint-dir``."""

import argparse

import numpy as np
import pytest
import torch

from flowfusion_torch import cli
from flowfusion_torch.utils import serving
from flowfusion_torch.utils.checkpoint import read_npz_extra
from flowfusion_torch.utils.data import DEMO_GMM

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _data(tmp_path, n=400, seed=0, name="x.f32"):
    x = DEMO_GMM.sample(torch.Generator().manual_seed(seed), n, device="cpu").numpy()
    path = str(tmp_path / name)
    x.astype(np.float32).tofile(path)
    return path, x


def _train(tmp_path, data, *extra, out="model.npz"):
    ckpt = str(tmp_path / out)
    cli.main(["train", "--data", data, "--dim", "2", "--units", "16", "16", "--stages", "64:1e-3",
              "--epochs", "2", "--out", ckpt, *extra, *CPU])
    return ckpt


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A diffusion checkpoint trained by the CLI (default --trace exact)."""
    tmp = tmp_path_factory.mktemp("cli")
    data, x = _data(tmp)
    return tmp, data, x, _train(tmp, data)


def test_cli_train_sample_logprob_roundtrip(trained, capsys):
    tmp, data, x, ckpt = trained
    meta = read_npz_extra(ckpt)  # embedded in the archive, no sidecar
    assert meta["dim"] == 2 and meta["family"] == "diffusion" and np.isfinite(meta["final_train_loss"])
    for method, extra in (("sde", ["--steps", "10"]), ("ode", [])):
        out = str(tmp / f"s_{method}.npy")
        cli.main(["sample", "--ckpt", ckpt, "--n", "64", "--method", method, "--out", out, *extra, *CPU])
        s = np.load(out)
        assert s.shape == (64, 2) and np.all(np.isfinite(s))
    for trace in ("exact", "hutchinson"):
        out = str(tmp / f"lp_{trace}.npy")
        capsys.readouterr()
        cli.main(["logprob", "--ckpt", ckpt, "--data", data, "--tol", "1e-3", "--trace", trace, "--out", out, *CPU])
        printed = capsys.readouterr().out
        lp = np.load(out)
        assert lp.shape == (400,) and np.all(np.isfinite(lp))
        assert "ok=True" in printed and f"sum={lp.sum():.2f}" in printed


def test_cli_export_roundtrip(trained):
    """export writes a symbolic-batch artifact that serves without the
    model code, the densities of the restored model's solve."""
    tmp, data, x, ckpt = trained
    art = str(tmp / "lp.pt2")
    cli.main(["export", "--ckpt", ckpt, "--tol", "1e-3", "--out", art, *CPU])
    f = serving.deserialize_log_prob(serving.load_artifact(art))
    model, _ = cli._restore(argparse.Namespace(ckpt=ckpt, trace=None, device="cpu"))
    xs = torch.from_numpy(x[:37])
    ref, _ = serving._align_to_target(model, None, likelihood=True).log_prob(xs, atol=1e-3, rtol=1e-3)
    assert torch.allclose(f(xs), ref, rtol=0, atol=1e-6)
    sampler = str(tmp / "s.pt2")
    cli.main(["export", "--ckpt", ckpt, "--what", "sampler", "--out", sampler, *CPU])
    g = serving.deserialize_sampler(serving.load_artifact(sampler))
    assert g(torch.zeros(5, 2)).shape == (5, 2)


def test_cli_export_buckets_roundtrip(trained):
    tmp, data, x, ckpt = trained
    bundle = str(tmp / "lp_buckets.pt2")
    cli.main(["export", "--ckpt", ckpt, "--trace", "hutchinson", "--buckets", "8,32", "--tol", "1e-3",
              "--out", bundle, *CPU])
    f = serving.deserialize_log_prob_bucketed(serving.load_artifact(bundle))
    assert f.buckets == (8, 32)
    lp = f(torch.from_numpy(x[:37]), seed=3)
    assert lp.shape == (37,) and bool(torch.isfinite(lp).all())
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["export", "--ckpt", ckpt, "--buckets", "8", "--batch", "8", "--out", bundle, *CPU])
    with pytest.raises(SystemExit, match="logprob"):
        cli.main(["export", "--ckpt", ckpt, "--what", "sampler", "--buckets", "8", "--out", bundle, *CPU])


@pytest.mark.parametrize("bad", ["8,abc", "0,8", ","])
def test_cli_export_buckets_validation(trained, bad):
    tmp, _, _, ckpt = trained
    with pytest.raises(SystemExit, match="buckets"):
        cli.main(["export", "--ckpt", ckpt, "--buckets", bad, "--out", str(tmp / "b.pt2"), *CPU])


@pytest.mark.parametrize("argv,match", [
    (["--what", "sampler", "--volume-corrected"], "volume-corrected"),
    (["--what", "sampler", "--tol", "1e-3"], "no effect"),
])
def test_cli_export_sampler_flag_validation(trained, argv, match):
    tmp, _, _, ckpt = trained
    with pytest.raises(SystemExit, match=match):
        cli.main(["export", "--ckpt", ckpt, "--out", str(tmp / "e.pt2"), *argv, *CPU])


def test_cli_export_refusal_speaks_cli_flags(trained, monkeypatch):
    """A serving guard's refusal becomes an exit with CLI advice; other
    errors are not swallowed."""
    tmp, _, _, ckpt = trained

    def refuse(*a, **k):
        raise serving.ExportRefused("not on this platform")

    monkeypatch.setattr(serving, "export_log_prob", refuse)
    with pytest.raises(SystemExit) as ei:
        cli.main(["export", "--ckpt", ckpt, "--out", str(tmp / "r.pt2"), *CPU])
    assert "export refused: not on this platform" in str(ei.value) and "--device" in str(ei.value)


@pytest.mark.parametrize("family,method", [("flow", "ode"), ("symplectic", "euler")])
def test_cli_family_roundtrip(tmp_path, family, method):
    data, x = _data(tmp_path, n=300, seed=1)
    ckpt = _train(tmp_path, data, "--family", family)
    assert read_npz_extra(ckpt)["family"] == family
    out = str(tmp_path / "s.npy")
    cli.main(["sample", "--ckpt", ckpt, "--n", "32", "--method", method, "--out", out, *CPU])
    assert np.load(out).shape == (32, 2)
    lp_out = str(tmp_path / "lp.npy")
    cli.main(["logprob", "--ckpt", ckpt, "--data", data, "--tol", "1e-3", "--out", lp_out, *CPU])
    lp = np.load(lp_out)
    assert lp.shape == (300,) and np.all(np.isfinite(lp))


def test_cli_family_flag_validation(tmp_path):
    """Wrong family/flag combinations die loudly, not silently."""
    data, _ = _data(tmp_path, n=128, seed=2)
    with pytest.raises(SystemExit, match="family diffusion only"):
        _train(tmp_path, data, "--family", "flow", "--sde", "vpsde")
    with pytest.raises(SystemExit, match="trace-free"):
        _train(tmp_path, data, "--family", "symplectic", "--trace", "hutchinson")
    ckpt = _train(tmp_path, data, "--family", "flow", out="flow.npz")
    with pytest.raises(SystemExit, match="probability-flow ODE only"):
        cli.main(["sample", "--ckpt", ckpt, "--n", "8", "--out", str(tmp_path / "s.npy"), *CPU])
    with pytest.raises(SystemExit, match="volume-corrected"):
        cli.main(["logprob", "--ckpt", ckpt, "--data", data, "--volume-corrected", "--out",
                  str(tmp_path / "lp.npy"), *CPU])
    with pytest.raises(SystemExit, match="stages"):
        _train(tmp_path, data, "--stages", "64-1e-3")


def test_cli_conditional_sample_requires_and_uses_cond_data(tmp_path, capsys):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((256, 3)).astype(np.float32)  # [x (2) | cond (1)]
    data = str(tmp_path / "xc.npy")
    np.save(data, rows)
    ckpt = _train(tmp_path, data, "--cond-dim", "1")
    out = str(tmp_path / "s.npy")
    with pytest.raises(SystemExit, match="--cond-data"):
        cli.main(["sample", "--ckpt", ckpt, "--n", "8", "--steps", "5", "--out", out, *CPU])
    cond = str(tmp_path / "c.npy")
    np.save(cond, rows[:20, 2:])
    cli.main(["sample", "--ckpt", ckpt, "--n", "12", "--steps", "5", "--cond-data", cond, "--out", out, *CPU])
    assert "first 12 of 20" in capsys.readouterr().out and np.load(out).shape == (12, 2)
    with pytest.raises(SystemExit, match="exceeds"):
        cli.main(["sample", "--ckpt", ckpt, "--n", "30", "--steps", "5", "--cond-data", cond, "--out", out, *CPU])


def test_cli_train_checkpoint_resume(tmp_path):
    """train --checkpoint-dir + --max-epochs: a budget-stopped run plus a
    resumed run write the checkpoint of one uninterrupted run."""
    data, _ = _data(tmp_path, n=256, seed=4)
    base = ["--trace", "hutchinson"]
    cli.main(["train", "--data", data, "--dim", "2", "--units", "16", "16", "--stages", "64:1e-3", "--epochs", "4",
              "--out", str(tmp_path / "full.npz"), *base, *CPU])
    cdir = str(tmp_path / "ck")
    resume = ["train", "--data", data, "--dim", "2", "--units", "16", "16", "--stages", "64:1e-3", "--epochs", "4",
              "--checkpoint-dir", cdir, "--checkpoint-every", "1", *base, *CPU]
    cli.main(resume + ["--out", str(tmp_path / "part.npz"), "--max-epochs", "2"])
    cli.main(resume + ["--out", str(tmp_path / "resumed.npz")])
    a, b = np.load(tmp_path / "full.npz"), np.load(tmp_path / "resumed.npz")
    for k in a.files:
        if k.startswith("leaf_"):
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        cli.main(["train", "--data", data, "--dim", "2", "--max-epochs", "2", "--out", str(tmp_path / "p.npz"),
                  *CPU])


def test_cli_needs_the_card_or_device_cpu(trained):
    """Without a visible card the commands exit, naming --device cpu; they
    never carry on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is the card")
    tmp, data, _, ckpt = trained
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["logprob", "--ckpt", ckpt, "--data", data, "--out", str(tmp / "lp.npy")])
