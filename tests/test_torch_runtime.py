"""The port's training runtime: the supervisor and the straggler policy
(copies of ``repro/runtime``), twins of ``tests/test_runtime.py``'s
supervisor and straggler tests, and a supervised restart of the port's
real tiny-agent train step (f32, CPU) that ends bit for bit where an
uninterrupted run ends: parameters, moments and every loss."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import models  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.types import AgentCard  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch.train import (AdamWConfig, TrainPlan,  # noqa: E402
                                      make_train_step)
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.runtime import (SimulatedFailure,  # noqa: E402
                                 StragglerPolicy, TrainSupervisor)
from repro_torch.runtime.supervisor import SupervisorConfig  # noqa: E402
from repro_torch.sim.clock import EventLoop  # noqa: E402


def _toy_step(state, batch, step):
    inc = float(batch["tokens"].mean()) * 1e-3
    return {"w": state["w"] + inc, "n": state["n"] + 1}


def test_supervisor_restart_bit_exact(tmp_path):
    data_cfg = DataConfig(vocab=100, seq_len=8, global_batch=2)
    ref_mgr = CheckpointManager(tmp_path / "ref", keep=2)
    sup0 = TrainSupervisor(ref_mgr, SupervisorConfig(ckpt_every=5,
                                                     async_ckpt=False))
    ref = sup0.run(state={"w": np.zeros(()), "n": np.zeros((), np.int64)},
                   pipeline=TokenPipeline(data_cfg), step_fn=_toy_step,
                   total_steps=20)

    mgr = CheckpointManager(tmp_path / "crashy", keep=2)
    sup = TrainSupervisor(mgr, SupervisorConfig(ckpt_every=5,
                                                async_ckpt=False))
    fail_at = {7, 13}

    def crashy(state, batch, step):
        if step in fail_at:
            fail_at.discard(step)
            raise SimulatedFailure(f"chaos at {step}")
        return _toy_step(state, batch, step)

    got = sup.run(state={"w": np.zeros(()), "n": np.zeros((), np.int64)},
                  pipeline=TokenPipeline(data_cfg), step_fn=crashy,
                  total_steps=20)
    assert sup.restarts == 2
    np.testing.assert_allclose(got["w"], ref["w"], rtol=0, atol=0)
    assert int(got["n"]) == int(ref["n"]) == 20


def test_supervisor_restart_budget(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    sup = TrainSupervisor(mgr, SupervisorConfig(ckpt_every=100,
                                                max_restarts=2))

    def always_fail(state, batch, step):
        raise SimulatedFailure("doomed")

    with pytest.raises(RuntimeError):
        sup.run(state={"w": np.zeros(())},
                pipeline=TokenPipeline(
                    DataConfig(vocab=10, seq_len=4, global_batch=1)),
                step_fn=always_fail, total_steps=5)


class FakeKnobbed:
    """``tests/test_controller.py``'s knobbed stand-in, on the port's
    types."""

    def __init__(self, name):
        self.name = name
        self.kind = "llm"
        self.values = {"max_num_seqs": 8, "admit_priority_min": 0}
        self._defaults = {}

    def card(self):
        return AgentCard(name=self.name, kind=self.kind,
                         knobs=dict(self.values), metrics=("queue_len",),
                         capabilities=("kv_transfer",))

    def get_param(self, k):
        return self.values[k]

    def set_param(self, k, v):
        if k not in self.values:
            raise KeyError(k)
        self._defaults.setdefault(k, self.values[k])
        self.values[k] = v

    def reset_param(self, k):
        if k in self._defaults:
            self.values[k] = self._defaults[k]


def test_straggler_demotes_slow_instance():
    from repro_torch.core.controller import Controller
    from repro_torch.core.metrics import CentralPoller, Collector, StateStore
    from repro_torch.core.registry import Registry

    loop = EventLoop()
    reg = Registry()
    fast, slow = FakeKnobbed("t0"), FakeKnobbed("t1")
    reg.register(fast)
    reg.register(slow)
    poller = CentralPoller(StateStore(), window=10.0)
    col = Collector()
    poller.attach(col)
    c = Controller(loop, reg, poller, interval=0.1)
    pol = StragglerPolicy(["t0", "t1"], ratio=2.0, window=10.0)
    c.install(pol)
    for i in range(10):
        col.observe("t0.step_time", 0.01, 0.1 * i)
        col.observe("t1.step_time", 0.08, 0.1 * i)   # 8x slower
    c.start()
    loop.run_until(1.0)
    assert "t1" in pol.demoted
    assert slow.values["admit_priority_min"] == 1
    for i in range(40):
        col.observe("t1.step_time", 0.01, 1.0 + 0.1 * i)
    loop.run_until(8.0)
    assert "t1" not in pol.demoted
    assert slow.values["admit_priority_min"] == 0
    assert pol.healthy() == ["t0", "t1"]


def train_run(tmp, fail_at=()):
    """tiny-agent f32 on the CPU, 12 steps of B 2 x S 16, checkpoints
    every 4 (async), failures injected at ``fail_at``.  Returns (state,
    losses of the steps that ran, restarts)."""
    cfg = get_config("tiny-agent").replace(dtype="float32")
    acfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12,
                       int8_moments=True)
    step_fn = make_train_step(cfg, None, TrainPlan(int8_moments=True), acfg,
                              device="cpu")
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    pending = set(fail_at)
    losses = {}

    def one(state, batch, step):
        if step in pending:
            pending.discard(step)
            raise SimulatedFailure(f"chaos at {step}")
        p, o, m = step_fn(*state, batch)
        losses[step] = m["loss"].item()
        return (p, o)

    sup = TrainSupervisor(CheckpointManager(tmp, keep=2),
                          SupervisorConfig(ckpt_every=4))
    state = sup.run(state=(params, adamw_init(params, acfg)),
                    pipeline=TokenPipeline(DataConfig(
                        vocab=cfg.vocab, seq_len=16, global_batch=2,
                        seed=5)),
                    step_fn=one, total_steps=12)
    return state, losses, sup.restarts


def test_supervised_restart_of_the_real_train_step_is_bit_exact(tmp_path):
    ref, ref_losses, _ = train_run(tmp_path / "ref")
    got, losses, restarts = train_run(tmp_path / "crashy", fail_at=(6, 9))
    assert restarts == 2
    assert losses == ref_losses and len(losses) == 12
    a, b = flatten(got)[0], flatten(ref)[0]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
