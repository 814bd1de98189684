"""The eight sim examples' twins under ``src/repro_torch/examples/``
against the JAX package's ``examples/``.

Each twin differs from its example only in import paths (and the
listed edits: the trace twin writes under a directory it is given).
With the port's cost figures set to the reference's and both id
counters restarted (``test_torch_agents.aligned``), each twin prints
what its reference prints under ``tests/test_examples.py``'s clamped
clock.  Tolerance: stdout equal, character for character.
"""
import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401
from test_examples import SIM_EXAMPLES, load_example  # noqa: E402
from test_torch_agents import aligned  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
# the twins of every sim example
TWINS = ("quickstart", "workflow", "autoscale", "prefix_cache", "trace",
         "tenancy", "disagg", "failover_drill")
# each twin's edits beyond the import paths: (text in the reference,
# text in the twin)
TWIN_EDITS = {
    "trace": (
        ('path = Path(__file__).resolve().parent.parent / "tools"',
         'path = Path(__file__).resolve().parents[3] / "tools"'),
        ("def main():", "def main(out_dir=None):"),
        ('    out = Path(tempfile.mkdtemp(prefix="trace_example_")) / '
         '"TRACE_fig1.json"',
         '    out = Path(out_dir or tempfile.mkdtemp(prefix="trace_example_")) '
         '\\\n        / "TRACE_fig1.json"')),
}


def test_twins_cover_the_sim_examples():
    assert set(TWINS) == set(SIM_EXAMPLES)


@pytest.mark.parametrize("name", TWINS)
def test_twin_differs_from_its_example_only_in_import_paths(name):
    src = (ROOT / "examples" / f"{name}.py").read_text()
    want = src.replace("repro.", "repro_torch.").replace(
        f"PYTHONPATH=src python examples/{name}.py",
        f"PYTHONPATH=src python -m repro_torch.examples.{name}")
    for old, new in TWIN_EDITS.get(name, ()):
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert (ROOT / "src/repro_torch/examples" / f"{name}.py").read_text() \
        == want


@pytest.mark.parametrize("name", TWINS)
def test_twin_prints_what_its_example_prints(name, aligned, capsys,
                                             tmp_path):
    aligned()
    load_example(name).main()
    want = capsys.readouterr().out
    aligned()
    twin = importlib.import_module(f"repro_torch.examples.{name}")
    if name == "trace":
        twin.main(tmp_path)
        assert (tmp_path / "TRACE_fig1.json").exists()
    else:
        twin.main()
    got = capsys.readouterr().out
    assert got == want
    assert "tasks completed" in got or "OK" in got
