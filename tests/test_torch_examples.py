"""The examples' twins on flowfusion_torch, run on the CPU: each demo's
``main`` to its end with the numbers it prints returned finite, the device
rule (no card and no ``--device``: exit naming ``--device cpu``), and the
notebook twins against their generator.

The runs take ``--quick`` where it fits the file's budget on one core, else
the JAX demo's own size flags: the conditional twin ``--n-train 2000
--n-eval 2000`` (its ``--quick`` evaluates 20,000 rows on the plain path).  The
serving twin runs against the JAX package in ``test_torch_examples_jax.py``.
"""

import ast
import importlib.util
import json
import math
import os

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TWINS = ("diffusion", "flow", "symplectic", "conditional_population", "likelihood_training", "serving")


def twin(name):
    """The twin ``examples/demo_<name>_torch.py`` as a module."""
    path = os.path.join(EXAMPLES, f"demo_{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"demo_{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numbers(tree):
    """Every number of a returned dict (nested dicts and lists)."""
    if isinstance(tree, dict):
        return [v for x in tree.values() for v in numbers(x)]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in numbers(x)]
    return [tree] if isinstance(tree, (int, float)) and not isinstance(tree, bool) else []


RUNS = {
    "diffusion": (["--quick"], lambda r: (
        set(r["sum"]) == set(r["nfe"]) == set(r["relative_error"]) == {"exact", "hutchinson", "hutchpp", "xtrace"}
        and r["epochs"] == 20 and r["ode"]["nfe"] > 0 and len(r["sde"]["mean"]) == 2)),
    "flow": (["--quick"], lambda r: r["epochs"] == 20 and r["nfe"] > 0 and r["sample"]["nfe"] > 0),
    "symplectic": (["--quick"], lambda r: (
        set(r["sample"]) == {"euler:1", "euler:16", "leapfrog:8"} and r["k1"]["nfe"] > 0 and r["k16"]["nfe"] > 0
        and r["epochs"] == 10)),
    "conditional_population": (["--n-train", "2000", "--n-eval", "2000"], lambda r: (
        r["n_eval"] == 2000 and r["epochs"] == 120 and r["nfe"] > 0 and r["n_devices"] == 1
        and abs(r["mean_offset"]) < 10 and 0 < r["scatter"] < 10)),
    "likelihood_training": (["--quick"], lambda r: (
        r["mle_steps"] == 30 and len(r["nll"]) == 30 and r["before"]["nfe"] > 0 and r["after"]["nfe"] > 0
        and r["epochs"] == 10)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_twin_runs_to_its_end(name, capsys):
    argv, shape_ok = RUNS[name]
    report = twin(name).main(argv + ["--device", "cpu"])
    assert report["device"] == "cpu" and report["wall"] > 0
    vals = numbers(report)
    assert vals and all(math.isfinite(v) for v in vals), report
    assert shape_ok(report), report
    json.dumps(report)  # plain numbers only: what the chip script prints
    out = capsys.readouterr().out
    assert "relative error" in out or "mean offset" in out or "log_prob" in out or "rel err" in out, out


@pytest.mark.parametrize("name", TWINS)
def test_twin_needs_the_card_or_device_cpu(name):
    """Without a visible card and without ``--device`` a twin exits naming
    the flag; it never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is the card")
    with pytest.raises(SystemExit, match="--device cpu"):
        twin(name).main(["--quick"])


def test_twins_take_the_jax_demos_flags():
    """Each twin parses the JAX demo's flags with the same defaults, plus
    ``--device`` (the diffusion demo's ``--tpu-schedule`` is
    ``--large-batch-schedule``)."""
    import re

    for name in TWINS:
        with open(os.path.join(EXAMPLES, f"demo_{name}.py")) as f:
            jax_src = f.read()
        with open(os.path.join(EXAMPLES, f"demo_{name}_torch.py")) as f:
            src = f.read()
        flags = re.findall(r'add_argument\(\s*"(--[a-z-]+)"(?:,\s*type=\w+,\s*default=([\w.-]+))?', jax_src)
        assert flags, name
        for flag, default in flags:
            flag = "--large-batch-schedule" if flag == "--tpu-schedule" else flag
            if flag == "--out":
                continue  # the artifact path: a .pt2 under the temp directory
            pattern = re.escape(flag) + (r'",\s*type=\w+,\s*default=' + re.escape(default) if default else "")
            assert re.search(pattern, src), (name, flag, default)
        assert '"--device"' in src, name


def test_notebooks_are_the_generators_output():
    """The committed notebook twins equal what ``make_notebooks_torch.py``
    writes (unexecuted), every code cell parses, and no cell imports JAX
    or the JAX package."""
    spec = importlib.util.spec_from_file_location("make_notebooks_torch", os.path.join(EXAMPLES,
                                                                                     "make_notebooks_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert set(gen.NOTEBOOKS) == {"demo_diffusion_torch.ipynb", "demo_flow_torch.ipynb"}
    assert gen.main(["--check"]) == 0
    for name in gen.NOTEBOOKS:
        with open(os.path.join(EXAMPLES, name), encoding="utf-8") as f:
            nb = json.load(f)
        assert nb["nbformat"] == 4 and nb["cells"]
        code = ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]
        assert code and all(not c["outputs"] and c["execution_count"] is None
                            for c in nb["cells"] if c["cell_type"] == "code")
        for src in code:
            tree = ast.parse(src)
            mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
            mods |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
            assert not mods & {"jax", "optax", "flowfusion_tpu"}, (name, mods)
        assert any("flowfusion_torch" in src for src in code)
