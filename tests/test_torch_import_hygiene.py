"""flowfusion_torch imports neither JAX nor the JAX package, and neither
does the chip smoke script."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fresh_interpreter_imports_every_module_without_jax():
    code = (
        "import importlib, pkgutil, sys, flowfusion_torch\n"
        "for m in pkgutil.walk_packages(flowfusion_torch.__path__, 'flowfusion_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'flowfusion_tpu')))\n"
        "print(len([k for k in sys.modules if k.startswith('flowfusion_torch')]), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


IMPORTS = re.compile(r"^\s*(import|from)\s+(jax|flowfusion_tpu)\b", re.M)


def _offenders(path, pattern):
    with open(path) as f:
        return [(os.path.relpath(path, ROOT), m.group(0).strip()) for m in pattern.finditer(f.read())]


def test_no_source_imports_or_names_the_jax_package():
    """No Python file of the port imports JAX or names the JAX package at
    all (docstrings point at "the JAX package's kernels/fused_mlp.py").
    The CUDA sources' header comments and chip_smoke.py's kernel report
    name the Pallas kernel they replace by its path; they import neither."""
    files, sources = [], []
    for dirpath, _, names in os.walk(os.path.join(ROOT, "flowfusion_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
        sources += [os.path.join(dirpath, n) for n in names if n.endswith((".cu", ".cuh"))]
    assert len(files) > 20
    assert {os.path.basename(p) for p in sources} >= {"fused_mlp.cu", "em_sampler.cu", "fused_sketch.cu", "fused_train.cu", "mlp_tile.cuh"}
    anywhere = re.compile(IMPORTS.pattern + r"|flowfusion_tpu", re.M)
    offenders = [o for path in files for o in _offenders(path, anywhere)]
    offenders += [o for path in sources + [os.path.join(ROOT, "chip_smoke.py")]
                  for o in _offenders(path, IMPORTS)]
    assert offenders == []
