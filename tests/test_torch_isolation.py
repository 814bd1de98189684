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
from test_torch_threads import one_torch_thread  # noqa: E402,F401

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
              "repro_torch.configs.kimi_k2_1t_a32b",
              "repro_torch.configs.gemma3_27b",
              "repro_torch.configs.h2o_danube_3_4b",
              "repro_torch.configs.llama3_405b",
              "repro_torch.configs.command_r_plus_104b",
              "repro_torch.configs.qwen2_vl_2b",
              "repro_torch.configs.xlstm_350m",
              "repro_torch.configs.seamless_m4t_large_v2",
              "repro_torch.serving.graphs",
              "repro_torch.serving.prefix_cache",
              "repro_torch.core.metrics", "repro_torch.core.registry",
              "repro_torch.core.rules", "repro_torch.core.controller",
              "repro_torch.core.intent", "repro_torch.core.policies",
              "repro_torch.core.trace", "repro_torch.core.dataplane",
              "repro_torch.core.tenancy", "repro_torch.sim.clock",
              "repro_torch.sim.network", "repro_torch.examples.serve_llm",
              "repro_torch.sim.costmodel", "repro_torch.sim.calibration",
              "repro_torch.serving.router", "repro_torch.serving.kv_transfer",
              "repro_torch.serving.engine_sim",
              "repro_torch.serving.disagg", "repro_torch.agents",
              "repro_torch.agents.protocol", "repro_torch.agents.stage",
              "repro_torch.agents.agent", "repro_torch.agents.graph",
              "repro_torch.agents.pipeline", "repro_torch.agents.workloads",
              "repro_torch.runtime.elastic", "repro_torch.runtime.heartbeat",
              "repro_torch.examples.quickstart",
              "repro_torch.examples.workflow",
              "repro_torch.examples.autoscale",
              "repro_torch.examples.prefix_cache",
              "repro_torch.examples.trace", "repro_torch.examples.tenancy",
              "repro_torch.examples.disagg", "repro_torch.optim",
              "repro_torch.optim.adamw", "repro_torch.launch",
              "repro_torch.launch.train", "repro_torch.data",
              "repro_torch.data.pipeline", "repro_torch.checkpoint",
              "repro_torch.checkpoint.manager",
              "repro_torch.runtime.supervisor",
              "repro_torch.runtime.straggler", "repro_torch.kernels.grad",
              "repro_torch.examples.train_lm",
              "repro_torch.examples.failover_drill",
              "repro_torch.distributed",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.collectives",
              "repro_torch.distributed.parallel",
              "repro_torch.launch.mesh", "repro_torch.launch.specs",
              "repro_torch.launch.serve", "repro_torch.launch.dryrun",
              "repro_torch.kernels.attention_combine",
              "repro_torch.kernels.work", "repro_torch.launch.fake_world"):
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
    xlstm = get_smoke("xlstm-350m")
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_cache(xlstm, 2, 64, layout="ring")
    params = models.init(xlstm, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(xlstm, params, SchedulerConfig(), cache_layout="ring")
    seamless = get_smoke("seamless-m4t-large-v2")
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_cache(seamless, 2, 64, enc_len=16)
    from repro_torch.examples import serve_llm, train_lm
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_llm.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--steps", "1"])
    from repro_torch.launch.train import make_train_step
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import ShapeMesh, make_mesh
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    one = ShapeMesh(("data", "model"), (1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serve_step(cfg, one, ShapeConfig("d", 32, 2, "decode"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_prefill_step(cfg, None, ShapeConfig("p", 32, 2, "prefill"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, one)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 2), ("data", "model"))

    class CudaMesh:
        """A DeviceMesh's surface, on CUDA."""
        device_type = "cuda"
        mesh_dim_names = ("data", "model")
        shape = (1, 2)

        def get_group(self, name):
            raise AssertionError("no group is built without CUDA")

    for mesh in (CudaMesh(),):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_step(cfg, mesh)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_serve_step(cfg, mesh, ShapeConfig("d", 32, 2, "decode"))


def test_chip_smoke_refuses_missing_cuda(monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chip_smoke.main()
