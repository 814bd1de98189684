"""The MoE models on the port's engine vs the JAX reference.

Both packages serve ``get_smoke("arctic-480b")`` (2 MoE layers of 8
experts, top-2, each with a dense residual MLP) and
``get_smoke("kimi-k2-1t-a32b")`` (a dense first layer, then 2 MoE layers
with a shared expert) in f32 with the same weights (``from_jax`` of the
reference's init), in both KV layouts.  With ``use_pallas`` on, every MoE
layer's three expert products go through the ``grouped_matmul`` wrapper,
which runs its plain version on CPU tensors; the reference's MoE is jnp
either way.  Greedy tokens must be equal, exactly.

Prompts of 70 and 100 tokens route 140 and 200 (token, expert) pairs
into a capacity of 24 and 32 per expert, which random routing can
overflow (tests/test_torch_moe.py forces drops); a decode step routes 4
pairs into 8 and never drops.

Also here: the plan and parameter count at full width, the ``from_jax``
round trip of the MoE trees (the router stays f32), and the sliced
random init of leaves too large to draw whole.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.kernels import grouped_matmul  # noqa: E402
from repro_torch.models import params as tprm  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

SCHED = dict(max_slots=2, num_pages=64, max_context=128, page_size=16)
LENS = [70, 100]
MOE = ("arctic-480b", "kimi-k2-1t-a32b")


@functools.lru_cache(maxsize=None)
def _tree(name):
    jcfg = jsmoke(name).replace(dtype="float32")
    return jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


def setup(name, **kw):
    kw = {"dtype": "float32", **kw}
    return (jsmoke(name).replace(**kw), tsmoke(name).replace(**kw),
            _tree(name))


def port_engine(tcfg, tree, layout, name="port"):
    return TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       SchedulerConfig(**SCHED), name=name,
                       cache_layout=layout, device="cpu")


def prompts(vocab, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def serve(eng, req_cls, ps, max_new=6):
    reqs = [req_cls(prompt_len=len(p), max_new_tokens=max_new,
                    prompt_tokens=p) for p in ps]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    for r in reqs:
        assert r.state.value == "finished"
        assert len(r.output_tokens) == max_new
    return [list(r.output_tokens) for r in reqs]


@functools.lru_cache(maxsize=None)
def reference_tokens(name, layout):
    """The JAX ``Engine``'s greedy tokens (jnp MoE in either layout)."""
    jcfg, _, tree = setup(name)
    eng = Engine(jcfg, jax.tree.map(jnp.asarray, tree), JSched(**SCHED),
                 name="ref", cache_layout=layout)
    return serve(eng, JRequest, prompts(jcfg.vocab))


def test_plan_and_param_count_match_reference():
    """arctic-480b: one segment of 35 MoE layers, 476,850,275,328
    parameters, 27,681,131,520 at the card's 2 layers; kimi-k2: a dense
    first layer, then MoE; the smoke plans as the reference's."""
    for name in MOE:
        jcfg, tcfg = jget(name), tget(name)
        # the two packages' dataclasses are distinct types of equal fields
        assert repr(tcfg.plan()) == repr(jcfg.plan())
        assert tmodels.param_count(tcfg) == jmodels.param_count(jcfg)
        assert repr(tsmoke(name).plan()) == repr(jsmoke(name).plan())
    assert tmodels.param_count(tget("arctic-480b")) == 476_850_275_328
    assert tmodels.param_count(tget("arctic-480b").replace(n_layers=2)) \
        == jmodels.param_count(jget("arctic-480b").replace(n_layers=2)) \
        == 27_681_131_520
    kimi = tsmoke("kimi-k2-1t-a32b").plan()
    assert [(s.pattern[0][0].moe, s.pattern[0][1]) for s in kimi] == \
        [(False, 1), (True, 2)]


@pytest.mark.parametrize("name", MOE)
def test_from_jax_round_trip(name):
    """The reference's MoE tree through ``from_jax`` and back: the same
    structure, shapes and values; cast to bf16, every leaf but the f32
    router and norms takes the new dtype."""
    _, tcfg, tree = setup(name)
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    ref_leaves = jax.tree.leaves(tree)
    port_leaves = tprm.tree_leaves(params)
    assert len(ref_leaves) == len(port_leaves)
    for a, t in zip(ref_leaves, port_leaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    moe = params["decoder"][-1]["e0"]["moe"]
    assert moe["w_in"].shape == (2, tcfg.n_experts, tcfg.d_model,
                                 tcfg.d_ff_expert)
    half = tmodels.from_jax(tcfg, tree, device="cpu", dtype=torch.bfloat16)
    moe = half["decoder"][-1]["e0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_out"].dtype == torch.bfloat16
    assert half["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("use_pallas", [False, True], ids=["bmm", "kernel"])
@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("name", MOE)
def test_moe_greedy_tokens_match_reference(name, layout, use_pallas):
    _, tcfg, tree = setup(name, use_pallas=use_pallas)
    teng = port_engine(tcfg, tree, layout)
    got = serve(teng, Request, prompts(tcfg.vocab))
    assert got == reference_tokens(name, layout)
    assert teng.prefill_steps > 0 and teng.decode_steps > 0


@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("name", MOE)
def test_moe_engine_calls_grouped_matmul_per_layer(name, layout,
                                                   monkeypatch):
    """With use_pallas, every forward (a prefill or a decode step) calls
    the wrapper three times per MoE layer: w_in and w_gate on the
    (E, C, d) buffer, w_out on (E, C, f); a decode step routes every
    slot at once.  On the CPU no kernel launches."""
    from repro_torch.models import moe

    _, tcfg, tree = setup(name, use_pallas=True)
    eng = port_engine(tcfg, tree, layout)
    n_moe = sum(s.n_layers for s in tcfg.plan() if s.pattern[0][0].moe)
    calls = []

    def spy(x, w, counts):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return grouped_matmul(x, w, counts)

    monkeypatch.setattr(moe, "grouped_matmul", spy)
    launches = grouped_matmul.launches
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert

    def per_forward(c):
        return [((e, c, d), (e, d, f)), ((e, c, d), (e, d, f)),
                ((e, c, f), (e, f, d))] * n_moe

    r = Request(prompt_len=70, max_new_tokens=3,
                prompt_tokens=prompts(tcfg.vocab, [70])[0])
    eng.submit(r)
    eng.step()                                     # prefill
    assert calls == per_forward(moe.capacity(70, tcfg))
    calls.clear()
    eng.step()                                     # decode
    assert calls == per_forward(moe.capacity(SCHED["max_slots"], tcfg))
    eng.run_until_idle()
    assert grouped_matmul.launches == launches     # CPU: plain version


# ---------------------------------------------------------------------------
# Random init: leaves too large to draw whole are drawn in slices
# ---------------------------------------------------------------------------


def whole_draw(defs, seed, dtype):
    """The init rule as it was before slicing: every normal leaf drawn
    whole in f32, in the walk order of ``init_params``."""
    gen = torch.Generator().manual_seed(seed)

    def one(p):
        dt = tprm.torch_dtype(p.dtype) if p.dtype else dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        x = torch.randn(p.shape, generator=gen, dtype=torch.float32)
        return x.mul_(p.scale / math.sqrt(max(fan_in, 1))).to(dt)

    return tprm.tree_map(one, defs)


@pytest.mark.parametrize("name,dtype", [("tiny-agent", "float32"),
                                        ("hymba-1.5b", "bfloat16"),
                                        ("arctic-480b", "bfloat16"),
                                        ("kimi-k2-1t-a32b", "float32")])
def test_init_of_small_models_is_unchanged(name, dtype):
    """Below ``MAX_DRAW`` every leaf is drawn whole, so small configs'
    random weights are bit-identical to the whole-leaf rule's."""
    cfg = tsmoke(name).replace(dtype=dtype)
    defs = tmodels.model_defs(cfg)
    assert max(math.prod(p.shape) for p in tprm.tree_leaves(defs)) \
        <= tprm.MAX_DRAW
    got = tmodels.init(cfg, torch.Generator().manual_seed(7), device="cpu")
    want = whole_draw(defs, 7, getattr(torch, dtype))
    for a, b in zip(tprm.tree_leaves(got), tprm.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_full_size_leaves_drawn_whole_or_sliced_as_intended():
    """agent-7b's and hymba-1.5b's leaves stay under the threshold (their
    chip_smoke weights do not change); arctic-480b's stacked expert
    weights do not."""
    for name in ("agent-7b", "hymba-1.5b"):
        leaves = tprm.tree_leaves(tmodels.model_defs(tget(name)))
        assert max(math.prod(p.shape) for p in leaves) <= tprm.MAX_DRAW
    arctic = tmodels.model_defs(tget("arctic-480b").replace(n_layers=2))
    w_in = arctic["decoder"][0]["e0"]["moe"]["w_in"]
    assert w_in.shape == (2, 128, 7168, 4864)
    assert math.prod(w_in.shape) > tprm.MAX_DRAW


def test_leaf_above_threshold_is_drawn_in_slices(monkeypatch):
    """A leaf above ``MAX_DRAW`` is drawn in slices along its leading
    dims, the slices as large as the threshold allows and as many of them
    a draw as it holds, in order; leaves below it are drawn whole."""
    monkeypatch.setattr(tprm, "MAX_DRAW", 3 * 4 * 5)
    shapes = []
    real = torch.randn

    def spy(*shape, **kw):
        shapes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real(*shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    defs = {"big": tprm.P((2, 3, 4, 5), (None,) * 4),
            "bigger": tprm.P((2, 7, 4, 5), (None,) * 4, scale=2.0),
            "small": tprm.P((3, 4, 5), (None,) * 3)}
    got = tprm.init_params(defs, torch.Generator().manual_seed(1),
                           torch.float32, torch.device("cpu"))
    # "big": one (3, 4, 5) slice a draw; "bigger": (4, 5) slices, three a
    # draw (60 elements), 7 = 3 + 3 + 1 of them under each leading index
    runs = [(3, 4, 5), (3, 4, 5), (1, 4, 5)]
    assert shapes == [(1, 3, 4, 5)] * 2 + runs * 2 + [(3, 4, 5)]
    gen = torch.Generator().manual_seed(1)
    std = 1 / math.sqrt(4)
    want = torch.stack([real((3, 4, 5), generator=gen) for _ in range(2)])
    assert torch.equal(got["big"], want * std)
    want = torch.cat([real(s, generator=gen) for s in runs * 2])
    assert torch.equal(got["bigger"], (want * 2 * std).reshape(2, 7, 4, 5))
    assert torch.equal(got["small"], real((3, 4, 5), generator=gen) * std)
