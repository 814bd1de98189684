"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
JAX and nothing of the reference package, and no entry point falls back
to the CPU silently."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules() -> list[str]:
    out = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(ROOT / "src").with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__"
                            else parts))
    return out


def test_import_pulls_in_no_jax_and_no_reference():
    mods = _modules()
    for m in ("repro_torch.models.ssm", "repro_torch.kernels.ssm_scan",
              "repro_torch.configs.hymba_1_5b", "repro_torch.models.moe",
              "repro_torch.kernels.grouped_matmul",
              "repro_torch.configs.arctic_480b",
              "repro_torch.configs.kimi_k2_1t_a32b"):
        assert m in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_source_imports_no_jax_and_no_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"


def test_entry_points_refuse_missing_cuda(monkeypatch):
    from repro_torch import models
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.serving import cache_utils
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny-agent")
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_cache(cfg, 2, 64, layout="paged", num_pages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_cache(cfg, 2, 64, layout="ring")
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_utils.ring_tree_from_numpy({"pos": np.zeros(1, np.int32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        models.from_jax(cfg, {})
    params = models.init(cfg, torch.Generator(), device="cpu")
    for layout in ("ring", "paged", None):
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchEngine(cfg, params, SchedulerConfig(), cache_layout=layout)
    hymba = get_smoke("hymba-1.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_cache(hymba, 2, 64, layout="ring")
    params = models.init(hymba, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(hymba, params, SchedulerConfig(), cache_layout="ring")
    arctic = get_smoke("arctic-480b")
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init(arctic, torch.Generator())
    params = models.init(arctic, torch.Generator(), device="cpu")
    for layout in ("ring", "paged"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchEngine(arctic, params, SchedulerConfig(),
                        cache_layout=layout)


def test_chip_smoke_refuses_missing_cuda(monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.main()
