"""The serving guards and the provenance envelope of the port's artifacts,
on the CPU: the cases of the JAX package's tests/test_serving.py:257-625
that have a meaning in the port (refusals, mixed platforms, bundle blobs, a
stamp mismatch that warns and then refuses under ``strict=True``, a
corrupt envelope), the bucketed bundle's dispatch, and an artifact served
by a fresh interpreter that loads only the serving module and none of
JAX."""

import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import flowfusion_torch
from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils import serving

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-3, rtol=1e-3)


def _model(trace_mode="hutchinson", C=0):
    cfg = ScoreMLPConfig(n_dimensions=2, n_conditionals=C, units=(16, 16))
    return ScoreModel(init_score_mlp(cfg, torch.Generator().manual_seed(0), torch.device("cpu")), cfg, VESDE(),
                      trace_mode=trace_mode)


def _x(n, d=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


@pytest.fixture(scope="module")
def blob():
    return serving.export_log_prob(_model(), **TOL)


@pytest.fixture(scope="module")
def bundle():
    return serving.export_log_prob_bucketed(_model(), batches=(4, 8), **TOL)


def test_export_refused_is_valueerror():
    assert issubclass(serving.ExportRefused, ValueError)


@pytest.mark.parametrize("platforms,match", [
    (("tpu",), "serves platforms"),
    (("cuda", "cpu"), "one platform|per platform"),
    (("cuda",), "move the model"),
])
def test_platform_refusals(platforms, match):
    """'tpu' is not a platform of the port; one artifact serves one
    platform; the target must be the model's device.  Each refusal comes
    before any tracing, for the likelihood and the sampler alike."""
    m = _model()
    with pytest.raises(serving.ExportRefused, match=match):
        serving.export_log_prob(m, platforms=platforms)
    with pytest.raises(serving.ExportRefused, match=match):
        serving.export_sampler(m, platforms=platforms)


def test_bare_string_platforms_is_a_type_error():
    with pytest.raises(TypeError, match="bare string"):
        serving.export_log_prob(_model(), platforms="cpu")


def test_explicit_kernel_refused_for_a_cpu_target():
    """use_fused_kernel=True asks for the CUDA kernel: a 'cpu' artifact
    cannot launch it (the JAX package's refusal, its serving.py:123-134)."""
    m = dataclasses.replace(_model(), use_fused_kernel=True)
    with pytest.raises(serving.ExportRefused, match="cannot launch"):
        serving.export_log_prob(m, platforms=("cpu",))
    with pytest.raises(serving.ExportRefused, match="cannot launch"):
        serving.export_sampler(m)


def test_targets_configure_the_kernel(monkeypatch):
    """A 'cpu' likelihood takes the op (its CPU kernel the plain version),
    a 'cpu' sampler the plain path; a 'cuda' target keeps the model's
    configuration and refuses a likelihood on the plain path, whose
    torch.func.jvp does not trace in the solver's while_loop."""
    m = _model()
    assert serving._align_to_target(m, None, likelihood=True).use_fused_kernel is True
    assert serving._align_to_target(m, None, likelihood=False).use_fused_kernel is False
    monkeypatch.setattr(serving, "_device", lambda model: torch.device("cuda"))
    assert serving._align_to_target(m, None, likelihood=True) is m
    plain = dataclasses.replace(m, use_fused_kernel=False)
    assert serving._align_to_target(plain, ("cuda",), likelihood=False) is plain
    with pytest.raises(serving.ExportRefused, match="while_loop"):
        serving._align_to_target(plain, ("cuda",), likelihood=True)


def test_unsupported_model_type():
    with pytest.raises(TypeError, match="unsupported model type"):
        serving.export_log_prob(object())


def test_provenance_roundtrip_and_stamp_contents(blob):
    assert bytes(blob[:8]) == serving._PROV_MAGIC
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a matched stamp must not warn
        f = serving.deserialize_log_prob(blob)
    prov = f.provenance
    assert prov["package"] == "flowfusion_torch"
    assert prov["package_version"] == flowfusion_torch.__version__
    assert prov["torch"] == torch.__version__ and prov["cuda"] == torch.version.cuda
    assert prov["platforms"] == ["cpu"] and "commit" in prov
    assert f(_x(8), seed=1).shape == (8,)


def test_provenance_mismatch_warns_then_strict_refuses(blob, monkeypatch):
    monkeypatch.setattr(flowfusion_torch, "__version__", "99.0.0")
    with pytest.warns(UserWarning, match="different toolchain"):
        f = serving.deserialize_log_prob(blob)
    assert f(_x(4)).shape == (4,)  # warn mode still serves
    with pytest.raises(ValueError, match="strict=True"):
        serving.deserialize_log_prob(blob, strict=True)


def test_bare_program_passes_through(blob):
    """A saved program without the envelope deserializes: no stamp."""
    raw, meta = serving._strip_provenance(blob, strict=False)
    assert meta is not None
    f = serving.deserialize_log_prob(raw)
    assert f.provenance is None and f(_x(4)).shape == (4,)


def test_bucketed_artifact_serves_any_batch(bundle, monkeypatch, tmp_path):
    """Requests pad with copies of their first row to the next bucket and
    chunk by the largest: each chunk is bitwise the eager solve of the
    padded rows with the same seed (through the op, whose CPU kernel the
    bundle's programs run)."""
    path = str(tmp_path / "bundle.pt2")
    serving.save_artifact(path, bundle)
    f = serving.deserialize_log_prob_bucketed(serving.load_artifact(path))
    assert f.buckets == (4, 8)
    monkeypatch.setattr(fused_mlp, "_on_card", lambda x: True)
    eager = serving._set_kernel(_model(), True)
    for n in (3, 8, 19):
        x = _x(n, seed=10 + n)
        lp = f(x, seed=2)
        assert lp.shape == (n,)
        chunks, pos = [], 0
        while pos < n:
            take = min(n - pos, 8)
            bucket = 4 if take <= 4 else 8
            xc = x[pos:pos + take]
            xc = torch.cat([xc, xc[:1].expand(bucket - take, -1)])
            gen = torch.Generator().manual_seed(2)
            chunks.append(eager.log_prob(xc, generator=gen, **TOL)[0][:take])
            pos += take
        assert torch.equal(lp, torch.cat(chunks))
    assert f(torch.zeros((0, 2))).shape == (0,)
    with pytest.raises(ValueError, match="unconditional"):
        f(_x(3), torch.zeros(3, 1))


def test_provenance_bucketed_single_warning(bundle, monkeypatch):
    """A mismatched bundle warns once (bundle level), not once a bucket,
    and refuses under strict=True."""
    export_version = flowfusion_torch.__version__
    monkeypatch.setattr(flowfusion_torch, "__version__", "99.0.0")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        f = serving.deserialize_log_prob_bucketed(bundle)
    assert len([w for w in rec if "different toolchain" in str(w.message)]) == 1
    assert f.provenance["package_version"] == export_version
    assert f(_x(6)).shape == (6,)
    with pytest.raises(ValueError, match="strict=True"):
        serving.deserialize_log_prob_bucketed(bundle, strict=True)


def test_deserializers_reject_the_other_kinds(blob, bundle):
    with pytest.raises(ValueError, match="bucketed bundle"):
        serving.deserialize_log_prob(bundle)
    with pytest.raises(ValueError, match="bucketed bundle"):
        serving.deserialize_sampler(bundle)
    with pytest.raises(ValueError, match="bad magic"):
        serving.deserialize_log_prob_bucketed(blob)
    with pytest.raises(ValueError, match="deserialize_log_prob"):
        serving.deserialize_sampler(blob)


def test_sampler_stamp_and_kind(monkeypatch):
    sblob = serving.export_sampler(_model(), batch=4)
    f = serving.deserialize_sampler(sblob)
    assert f.provenance["package"] == "flowfusion_torch"
    with pytest.raises(ValueError, match="deserialize_sampler"):
        serving.deserialize_log_prob(sblob)
    monkeypatch.setattr(flowfusion_torch, "__version__", "99.0.0")
    with pytest.raises(ValueError, match="strict=True"):
        serving.deserialize_sampler(sblob, strict=True)


def test_bucketed_dispatcher_validates_conditional():
    fc = serving.deserialize_log_prob_bucketed(
        serving.export_log_prob_bucketed(_model(C=3), batches=(8,), **TOL))
    x = _x(5)
    with pytest.raises(ValueError, match="conditional"):
        fc(x)
    with pytest.raises(ValueError, match="rows"):
        fc(x, _x(3, 3))
    assert fc(x, _x(5, 3, seed=1), seed=2).shape == (5,)


def test_corrupt_envelope_diagnosed(blob):
    with pytest.raises(ValueError, match="truncated"):
        serving.deserialize_log_prob(blob[:20])
    damaged = bytearray(blob)
    damaged[14] ^= 0xFF  # a byte inside the JSON header
    with pytest.raises(ValueError, match="damaged"):
        serving.deserialize_log_prob(bytes(damaged))


def test_fresh_interpreter_serves_the_artifact_without_jax(blob, tmp_path):
    """A process that imports only the serving module loads the artifact
    and gives the in-process densities bitwise; JAX is never imported."""
    path = str(tmp_path / "lp.pt2")
    serving.save_artifact(path, blob)
    x = _x(12, seed=3)
    np.save(tmp_path / "x.npy", x.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from flowfusion_torch.utils import serving\n"
        f"f = serving.deserialize_log_prob(serving.load_artifact({path!r}))\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'lp.npy')!r}, f(x, seed=9).numpy())\n"
        "print(sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'flowfusion_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path), env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    expected = serving.deserialize_log_prob(blob)(x, seed=9).numpy()
    assert np.array_equal(np.load(tmp_path / "lp.npy"), expected)
