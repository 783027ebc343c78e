"""The port's tutorial (docs/tutorials/torch_port_example.py) runs on the
CPU without jax, and docs/build.py turns it into a notebook as it does the
other tutorials."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTORIAL = os.path.join(REPO, "docs", "tutorials", "torch_port_example.py")


def test_tutorial_runs_on_the_cpu_without_jax():
    code = ("import runpy, sys\n"
            f"runpy.run_path({TUTORIAL!r}, run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'transport_analysis_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert out.count("timing") == 3 and "'compute'" in out
    assert "4 CPU shards vs unsharded" in out
    assert "viscosity slope: 0.00098" in out


def test_tutorial_converts_to_a_notebook():
    pytest.importorskip("nbformat")
    spec = importlib.util.spec_from_file_location(
        "docs_build", os.path.join(REPO, "docs", "build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    nb = build.py_to_notebook(TUTORIAL)
    assert nb.cells[0].cell_type == "markdown"
    assert "analysis.timing" in nb.cells[0].source
    code = [c.source for c in nb.cells if c.cell_type == "code"]
    assert len(code) >= 5 and any("use_mesh" in c for c in code)
