"""The tutorial notebooks (reference L5 deliverable format) must execute:
every code cell runs in order in a shared namespace, including the ED
comparison assertions inside the cells (NUM_STEPS reduced for CI wall-time;
the full budgets converge tighter)."""

import json
import os

import pytest

pytestmark = pytest.mark.slow

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _run_notebook(name, overrides):
    with open(os.path.join(EXAMPLES, name)) as f:
        nb = json.load(f)
    ns = {}
    for cell in nb["cells"]:
        if cell["cell_type"] != "code":
            continue
        src = "".join(cell["source"])
        exec(compile(src, name, "exec"), ns)  # noqa: S102 - our own cells
        for k, v in overrides.items():
            if k in ns:
                ns[k] = v
    return ns


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("Tutorial_1DTFIM.ipynb", {"NUM_STEPS": 500, "NUM_SAMPLES": 128}),
        ("Tutorial_1DJ1J2.ipynb", {"NUM_STEPS": 600, "NUM_SAMPLES": 128}),
    ],
)
def test_notebook_executes_and_converges(name, overrides):
    ns = _run_notebook(name, overrides)
    assert "est" in ns and "e_exact" in ns


def test_notebooks_match_generator(tmp_path):
    """The committed .ipynb files must be exactly what
    scripts/make_tutorial_notebooks.py emits — otherwise an edit to either
    side silently diverges the two sources while the execution test keeps
    passing against the stale artifact."""
    import importlib.util
    import sys

    script = os.path.join(
        os.path.dirname(__file__), "..", "scripts", "make_tutorial_notebooks.py"
    )
    spec = importlib.util.spec_from_file_location("make_tutorials", script)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["make_tutorials"] = mod
    spec.loader.exec_module(mod)
    mod.OUT_DIR = str(tmp_path)
    mod.main()
    for name in ("Tutorial_1DTFIM.ipynb", "Tutorial_1DJ1J2.ipynb"):
        with open(os.path.join(EXAMPLES, name)) as f:
            committed = f.read()
        with open(tmp_path / name) as f:
            generated = f.read()
        assert committed == generated, f"{name} diverges from its generator"
