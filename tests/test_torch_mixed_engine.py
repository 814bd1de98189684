"""TorchEngine's stall-free mixed step against the JAX ``Engine``'s.

The port runs every decode slot and one padded prefill chunk in one
step with fixed-shape inputs (``_mixed_cap`` tokens, block tables of
width ``P_max``, start / length / slot as 0-d device tensors), as the
reference's jitted ``_mixed_step``; on the CPU the step is built once
and called on its static buffers.  Both engines serve the same prompts
on the same weights (``from_jax`` of the reference's init), f32, and
their greedy tokens must be equal.  The matrix follows
tests/test_mixed_batching.py: GQA/MQA x chunk 0/7/16, the kernel flag
(the reference's Pallas kernel in interpret mode, the port's plain
version), and arctic-480b's smoke config, whose padded chunk routes its
pad tokens through the experts in both packages (capacity from the
chunk capacity, not its fill); and the port's kernels on (the paged
flash and paged decode wrappers' plain versions) against the
reference's flag off, dense, windowed and arctic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _jax_caps import HAVE_PALLAS_API, PALLAS_SKIP_REASON  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

PAGE = 16
TOL = 1e-4          # tests/test_paged_engine.py's prefill band


def setup(name="tiny-agent", **kw):
    get_j, get_t = ((jget, tget) if name == "tiny-agent"
                    else (jsmoke, tsmoke))
    jcfg = get_j(name).replace(dtype="float32", **kw)
    tcfg = get_t(name).replace(dtype="float32", **kw)
    tree = jax.device_get(jmodels.init(jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree


def sched_kw(mixed=True, chunk=0):
    return dict(max_slots=3, num_pages=64, max_context=128, page_size=PAGE,
                max_batch_tokens=64, prefill_chunk=chunk, mixed=mixed)


def engines(jcfg, tcfg, tree, **kw):
    jeng = Engine(jcfg, jax.tree.map(jnp.asarray, tree),
                  JSched(**sched_kw(**kw)), name="ref", cache_layout="paged")
    teng = TorchEngine(tcfg, tmodels.from_jax(tcfg, tree, device="cpu"),
                       SchedulerConfig(**sched_kw(**kw)), name="port",
                       cache_layout="paged", device="cpu")
    return jeng, teng


def prompts(vocab, *lens, seed=3):
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


@pytest.mark.parametrize("window", [-1, 24], ids=["full", "swa"])
def test_prefill_paged_padded_logit_parity(window):
    """A 20-token chunk in a 32-token buffer at start 5, after a resident
    5-token prefix: logits within 1e-4, ``pos`` = start + n, and the pad
    writes inert (the next decode step agrees too)."""
    jcfg, tcfg, tree = setup(window=window)
    tparams = tmodels.from_jax(tcfg, tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = prompts(jcfg.vocab, 25, seed=2)[0][None]
    tables = np.asarray([[3, 0, 7, 1, 5, -1]], np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 96, layout="paged", num_pages=8,
                                page_size=PAGE)
    tcache = tmodels.init_cache(tcfg, 2, 96, layout="paged", num_pages=8,
                                page_size=PAGE, device="cpu")
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    _, jcache = jtfm.prefill_paged(jparams, jcfg, jnp.asarray(toks[:, :5]),
                                   jcache, jt, jnp.zeros((1,), jnp.int32),
                                   jnp.int32(1))
    _, tcache = tmodels.prefill_paged(
        tparams, tcfg, torch.from_numpy(toks[:, :5]).long(), tcache, tt,
        torch.zeros(1, dtype=torch.int32), 1)
    start, n, cap = 5, 20, 32
    buf = np.zeros((1, cap), np.int32)
    buf[0, :n] = toks[0, start:start + n]
    lj, jcache = jtfm.prefill_paged_padded(
        jparams, jcfg, jnp.asarray(buf), jcache, jt, jnp.int32(start),
        jnp.int32(1), jnp.int32(n))
    lt, tcache = tmodels.prefill_paged_padded(
        tparams, tcfg, torch.from_numpy(buf).long(), tcache, tt,
        torch.tensor(start, dtype=torch.int32),
        torch.tensor(1, dtype=torch.int32), torch.tensor(n,
                                                         dtype=torch.int32))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                               atol=TOL)
    assert tcache["pos"].tolist() == [0, start + n]
    # every mapped page holds what the reference's does; pads hit the sink
    for seg_t, seg_j in zip(tcache["segments"], jcache["segments"]):
        np.testing.assert_allclose(seg_t["e0"]["kv"].k[:, :8].numpy(),
                                   np.asarray(seg_j["e0"]["kv"].k)[:, :8],
                                   rtol=TOL, atol=TOL)
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32).reshape(1, 1)
    tok = np.concatenate([np.zeros_like(tok), tok])
    tables2 = np.concatenate([np.full_like(tables, -1), tables])
    lj, _ = jmodels.decode_step(jparams, jcfg, jnp.asarray(tok), jcache,
                                jnp.asarray(tables2))
    lt, _ = tmodels.decode_step(tparams, tcfg, torch.from_numpy(tok).long(),
                                tcache, torch.from_numpy(tables2))
    np.testing.assert_allclose(lt.numpy()[1], np.asarray(lj)[1], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("chunk", [0, 7, 16], ids=["whole", "c7", "c16"])
@pytest.mark.parametrize("n_kv_heads", [2, 1], ids=["gqa", "mqa"])
def test_mixed_tokens_match_reference(n_kv_heads, chunk):
    jcfg, tcfg, tree = setup(n_kv_heads=n_kv_heads)
    jeng, teng = engines(jcfg, tcfg, tree, chunk=chunk)
    ps = prompts(jcfg.vocab, 35, 27, 37)
    assert serve(teng, Request, ps) == serve(jeng, JRequest, ps)
    assert teng.mixed_step_traces == jeng.mixed_step_traces == 1
    assert teng.step_runs["mixed"] > 0


def test_mixed_kernel_path_tokens_match_reference():
    """``use_pallas``: the reference's paged kernel in interpret mode for
    the decode rows, the port's plain version; chunk 8."""
    if not HAVE_PALLAS_API:
        pytest.skip(PALLAS_SKIP_REASON)
    jcfg, tcfg, tree = setup(use_pallas=True)
    jeng, teng = engines(jcfg, tcfg, tree, chunk=8)
    ps = prompts(jcfg.vocab, 33, 21)
    assert serve(teng, Request, ps) == serve(jeng, JRequest, ps)


@pytest.mark.parametrize("name,kw", [("tiny-agent", {}),
                                     ("tiny-agent", {"window": 24}),
                                     ("arctic-480b", {})],
                         ids=["dense", "dense-swa", "moe"])
def test_mixed_kernels_on_tokens_match_reference(name, kw):
    """The port with ``use_pallas`` -- its mixed chunk and serialized
    prefills on ``paged_flash_attention``, its decode rows on
    ``paged_decode_attention``, their plain versions here -- against the
    reference's mixed ``Engine`` with the flag off (the gather path and
    jnp decode, the same function): greedy tokens equal, chunk 16.
    arctic's padded chunk routes its pad rows through the experts in both
    packages."""
    jcfg, tcfg, tree = setup(name, **kw)
    jeng, teng = engines(jcfg, tcfg.replace(use_pallas=True), tree,
                         chunk=16)
    ps = prompts(jcfg.vocab, 40, 23, 31, seed=6)
    assert serve(teng, Request, ps) == serve(jeng, JRequest, ps)
    assert teng.step_runs["mixed"] > 0


@pytest.mark.parametrize("name", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_mixed_moe_tokens_with_zero_pad_rows(name, monkeypatch):
    """On the card the paged flash kernel writes zeros for the chunk's pad
    rows, where its plain version and the reference write the uniform
    average of an all-masked softmax; in an MoE layer the pad rows then
    route through the experts with other values, against the same
    capacity.  With the wrapper's plain version made to zero them as the
    kernel does, the port's MoE mixed tokens still equal the reference's
    (ROADMAP C, "A row with no valid key")."""
    from repro_torch.kernels.paged_flash_attention import (
        live_rows, paged_flash_attention_plain)
    from repro_torch.models import attention as tattn

    def as_the_kernel(*args, window=-1):
        out = paged_flash_attention_plain(*args, window=window)
        out[~live_rows(args[3], args[4], args[1].shape[1], window)] = 0
        return out
    monkeypatch.setattr(tattn, "paged_flash_attention", as_the_kernel)
    jcfg, tcfg, tree = setup(name)
    jeng, teng = engines(jcfg, tcfg.replace(use_pallas=True), tree,
                         chunk=16)
    ps = prompts(jcfg.vocab, 40, 23, 31, seed=9)
    assert serve(teng, Request, ps) == serve(jeng, JRequest, ps)


def test_mixed_moe_tokens_match_reference():
    """arctic-480b's smoke (MoE layers, a dense residual MLP): the padded
    chunk's pad tokens route through the experts in both packages."""
    jcfg, tcfg, tree = setup("arctic-480b")
    jeng, teng = engines(jcfg, tcfg, tree, chunk=16)
    ps = prompts(jcfg.vocab, 40, 23, seed=4)
    assert serve(teng, Request, ps) == serve(jeng, JRequest, ps)


def test_mixed_step_built_once_across_churn():
    """Admission churn, recycled slots and pages, varying chunk fill and
    a ``prefill_chunk`` move all run the one mixed step, whose static
    buffers keep their addresses; the decode step is built once too."""
    _, tcfg, tree = setup()
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    eng = TorchEngine(tcfg, params, SchedulerConfig(**sched_kw(chunk=8)),
                      cache_layout="paged", device="cpu")
    serve(eng, Request, prompts(tcfg.vocab, 35, 27, 37), max_new=5)
    assert eng.mixed_step_traces == 1
    static = {k: v.data_ptr() for k, v in
              eng._step_graph("mixed").static.items()}
    serve(eng, Request, prompts(tcfg.vocab, 19, 41, seed=11), max_new=3)
    eng.set_param("prefill_chunk", 5)
    serve(eng, Request, prompts(tcfg.vocab, 23, seed=29), max_new=3)
    assert eng.mixed_step_traces == 1
    assert eng.step_captures == {"mixed": 1, "decode": 1}
    assert {k: v.data_ptr() for k, v in
            eng._step_graph("mixed").static.items()} == static
    # a layout flip builds a new cache: the steps are built anew
    eng.set_param("mixed", False)
    eng.set_param("cache_layout", "ring")
    eng.set_param("cache_layout", "paged")
    eng.set_param("mixed", True)
    serve(eng, Request, prompts(tcfg.vocab, 23, seed=30), max_new=3)
    assert eng.mixed_step_traces == 2


def test_sampler_device_temperature():
    """Temperature is a 0-d tensor: at 0 the ids are argmax (first index
    on ties); above 0 they are draws that advance the generator; a tiny
    temperature gives argmax again."""
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((6, 300)).astype(np.float32))
    logits[0, 7] = logits[0, 9] = logits[0].max() + 1.0     # a tie
    gen = torch.Generator().manual_seed(0)
    greedy = sampler.sample(logits, gen, torch.tensor(0.0))
    assert greedy.dtype == torch.int32
    assert greedy.tolist() == torch.argmax(logits, -1).tolist()
    assert greedy[0] == 7
    assert sampler.sample(logits, gen, torch.tensor(1e-7)).tolist() \
        == greedy.tolist()
    hot = torch.tensor(1e4)
    a, b = sampler.sample(logits, gen, hot), sampler.sample(logits, gen, hot)
    assert a.tolist() != b.tolist() and a.tolist() != greedy.tolist()
    assert ((a >= 0) & (a < 300)).all()
    top = sampler.sample(logits, gen, hot, top_k=3)
    assert all(int(t) in torch.topk(logits[i], 3).indices.tolist()
               for i, t in enumerate(top))


def test_temperature_knob_moves_between_steps():
    """The ``temperature`` knob lands in the step's static buffer: greedy
    tokens until it moves, draws after, with no new build of the step."""
    _, tcfg, tree = setup()
    params = tmodels.from_jax(tcfg, tree, device="cpu")
    p = prompts(tcfg.vocab, 30)[0]

    def run(hot_after):
        eng = TorchEngine(tcfg, params, SchedulerConfig(**sched_kw()),
                          cache_layout="paged", device="cpu")
        r = Request(prompt_len=len(p), max_new_tokens=12, prompt_tokens=p)
        eng.submit(r)
        while r.state.value != "finished":
            if r.generated == hot_after:
                eng.set_param("temperature", 1e4)
            eng.step()
        assert eng.step_captures["decode"] == 1
        return list(r.output_tokens)

    greedy, moved = run(None), run(4)
    assert moved[:4] == greedy[:4]
    assert moved[4:] != greedy[4:]
