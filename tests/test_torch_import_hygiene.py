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
        "new = ('diagnostics', 'profiling', 'native_loader')\n"
        "assert all(f'flowfusion_torch.utils.{m}' in sys.modules for m in new)\n"
        "par = ('sharding', 'distributed', 'autoshard', '_collective')\n"
        "assert all(f'flowfusion_torch.parallel.{m}' in sys.modules for m in par)\n"
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
    The CUDA and C++ sources' header comments and chip_smoke.py's kernel report
    name the Pallas kernel they replace by its path; they import neither."""
    files, sources = [], []
    for dirpath, _, names in os.walk(os.path.join(ROOT, "flowfusion_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
        sources += [os.path.join(dirpath, n) for n in names if n.endswith((".cu", ".cuh", ".cpp"))]
    assert len(files) > 20
    assert {os.path.basename(p) for p in sources} >= {"fused_mlp.cu", "em_sampler.cu", "fused_sketch.cu", "fused_train.cu", "mlp_tile.cuh", "dataloader.cpp"}
    anywhere = re.compile(IMPORTS.pattern + r"|flowfusion_tpu", re.M)
    offenders = [o for path in files for o in _offenders(path, anywhere)]
    offenders += [o for path in sources + [os.path.join(ROOT, "chip_smoke.py")]
                  for o in _offenders(path, IMPORTS)]
    assert offenders == []


def test_kernel_package_names():
    """The kernel package's public names are the JAX package's
    ``kernels/__init__.py`` names, each the wrapper or predicate of its
    module, in a fresh interpreter."""
    code = (
        "import flowfusion_torch.kernels as k\n"
        "from flowfusion_torch.kernels import em_sampler, fused_mlp\n"
        "print(k.__all__)\n"
        "home = {n: em_sampler if n == 'fused_em_sample' else fused_mlp for n in k.__all__}\n"
        "print(all(getattr(k, n) is getattr(home[n], n) for n in k.__all__))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "['fusable_config', 'fused_drift', 'fused_drift_reference', 'fused_em_sample', 'fused_velocity', "
        "'pad_to_lanes', 'paddable_config', 'supports_config']",
        "True",
    ]


def test_imports_without_scipy():
    """scipy only backs dop853's coefficients, loaded on first use: with
    scipy unimportable every module imports and 'dop853' raises naming it."""
    code = (
        "import sys; sys.modules['scipy'] = None\n"
        "import importlib, pkgutil, flowfusion_torch\n"
        "for m in pkgutil.walk_packages(flowfusion_torch.__path__, 'flowfusion_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from flowfusion_torch.ops.integrate import odeint\n"
        "import torch\n"
        "try:\n"
        "    odeint(lambda t, y: -y, torch.ones(2), [0.0, 1.0], method='dop853')\n"
        "except ValueError as err:\n"
        "    print('scipy' in str(err))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True", out.stdout


def test_cli_and_serving_import_without_jax():
    """``cli``, ``__main__`` and ``utils.serving`` import neither JAX nor
    the JAX package, and ``python -m flowfusion_torch <command> --help``
    exits 0 for every command without loading a JAX module."""
    code = (
        "import runpy, sys\n"
        "import flowfusion_torch.cli, flowfusion_torch.__main__, flowfusion_torch.utils.serving\n"
        "codes = []\n"
        "for cmd in ('train', 'sample', 'logprob', 'export'):\n"
        "    sys.argv = ['flowfusion_torch', cmd, '--help']\n"
        "    try:\n"
        "        runpy.run_module('flowfusion_torch', run_name='__main__')\n"
        "    except SystemExit as err:\n"
        "        codes.append(err.code)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'flowfusion_tpu')))\n"
        "print(codes, bad, file=sys.stderr)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stderr.strip().splitlines()[-1] == "[0, 0, 0, 0] []", out.stderr
    for cmd in ("train", "export"):
        run = subprocess.run([sys.executable, "-m", "flowfusion_torch", cmd, "--help"], capture_output=True,
                             text=True, cwd=ROOT, env=env, timeout=120)
        assert run.returncode == 0 and "--device" in run.stdout, run.stderr


def test_jax_names_kept_as_thin_aliases():
    """The JAX public names whose rule the port has under another name:
    ``kernels.fused_train.supports_batch`` (``train_plan`` admits the net),
    ``models._common.auto_fused`` (``fused_dispatch``) and
    ``ops.integrate.tableaus.ADAPTIVE_TABLEAUS``; and the orbax checkpoint
    names map to ``save_dcp``/``load_dcp``, which the module text says."""
    from flowfusion_torch.kernels import fused_train
    from flowfusion_torch.models import _common
    from flowfusion_torch.models.nets import ScoreMLPConfig
    from flowfusion_torch.ops.integrate import tableaus
    from flowfusion_torch.utils import checkpoint

    cfg = ScoreMLPConfig(n_dimensions=2, units=(128,) * 3)
    assert fused_train.supports_batch(cfg, 512) and "supports_batch" in fused_train.__all__
    assert not fused_train.supports_batch(ScoreMLPConfig(n_dimensions=2, units=(4096,) * 3), 512)
    assert "auto_fused" in _common.__all__
    for use, supported, on_cuda in [(None, True, False), (None, True, True), (False, True, True), (True, True, False)]:
        assert _common.auto_fused(use, supported, on_cuda) == _common.fused_dispatch(use, supported, on_cuda)
    assert _common.auto_fused(None, True) is False
    tableaus.get_adaptive_tableau("dop853")  # built on first use: it stays out of ADAPTIVE_TABLEAUS
    assert set(tableaus.ADAPTIVE_TABLEAUS) == set(tableaus.ADAPTIVE_METHODS) - {"dop853"}
    assert all(tableaus.get_adaptive_tableau(n) is t for n, t in tableaus.ADAPTIVE_TABLEAUS.items())
    assert "ADAPTIVE_TABLEAUS" in tableaus.__all__
    assert "``save_dcp`` / ``load_dcp`` are the counterpart of the JAX package's\n``save_orbax`` / ``load_orbax``" in \
        checkpoint.__doc__


EXAMPLE_TWINS = ("diffusion", "flow", "symplectic", "conditional_population", "likelihood_training", "serving")
FORBIDDEN = ("jax", "optax", "flowfusion_tpu", "bench", "chip_smoke")


def test_example_twins_import_no_jax():
    """The examples' twins (``examples/demo_*_torch.py``) and their notebook
    generator import the standard library, torch, numpy and
    flowfusion_torch only: no JAX, optax, the JAX package, ``bench`` or
    ``chip_smoke``, in their source and in a fresh interpreter that loads
    each twin."""
    import ast

    paths = [os.path.join(ROOT, "examples", f"demo_{n}_torch.py") for n in EXAMPLE_TWINS]
    paths.append(os.path.join(ROOT, "examples", "make_notebooks_torch.py"))
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "flowfusion_torch"}
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert roots <= allowed, (os.path.basename(path), sorted(roots - allowed))
    code = (
        "import importlib.util, sys\n"
        f"for name in {EXAMPLE_TWINS!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name, {os.path.join(ROOT, 'examples')!r} + "
        "f'/demo_{name}_torch.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([k for k in sys.modules if k.startswith('flowfusion_torch')]), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout
