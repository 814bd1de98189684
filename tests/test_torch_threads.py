"""One intra-op thread for the port's CPU tests.

The port's tests run many small PyTorch ops.  Under ``pytest -n 6`` on a
machine of 8 cores, each worker's PyTorch would start a thread per core
and wait at every op for all of them; with the cores oversubscribed a
tiny engine step then takes many times longer (chip_smoke's hymba
rehearsal: 2 s alone, minutes beside five busy workers).  Every
``tests/test_torch_*.py`` file imports ``one_torch_thread``, which runs
its tests on one thread and restores the count afterwards.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tests_run_on_one_thread():
    assert torch.get_num_threads() == 1


def test_every_port_test_file_takes_the_fixture():
    from pathlib import Path

    for path in sorted(Path(__file__).parent.glob("test_torch_*.py")):
        if path.name == Path(__file__).name:
            continue
        assert "from test_torch_threads import one_torch_thread" in \
            path.read_text(), path.name
