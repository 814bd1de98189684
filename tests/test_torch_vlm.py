"""qwen2-vl (the VLM: M-RoPE over 3-axis positions, patch embeddings in
the token stream) in the port against the JAX reference.

Module level: ``apply_rope`` with ``mrope_sections`` (f32 and bf16, the
streams distinct) and ``default_positions`` (3 equal streams, with and
without an offset) equal the reference's.  Model level, f32 on the
smoke config with the reference's weights (``from_jax``): a prefill
whose first 12 slots are patch embeddings at (t, h, w) positions on a
4 x 3 grid, text after them, then decode steps; the mixed step's padded
chunk (``prefill_paged_padded``) at 3-axis positions.  Prefill logits
within 1e-4, decode within 2e-3 (the reference's bands,
tests/test_paged_engine.py:91-93).  Engine level: the JAX ``Engine``
serves the VLM text-only (it passes no patch embeddings), and the
port's greedy tokens equal its tokens in the paged and ring layouts and
with the mixed step, kernels on (their plain versions here) and off.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.core.types import Request as JRequest  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving.engine import Engine  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSched  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving.engine import TorchEngine  # noqa: E402
from repro_torch.serving.scheduler import SchedulerConfig  # noqa: E402

NAME = "qwen2-vl-2b"
TOL = 1e-4
DECODE_TOL = 2e-3
GRID = (4, 3)
SCHED = dict(max_slots=3, num_pages=64, max_context=128, page_size=16,
             max_batch_tokens=64)


@functools.lru_cache(maxsize=None)
def _tree():
    jcfg = jsmoke(NAME).replace(dtype="float32")
    return jax.device_get(jmodels.init(jcfg, jax.random.key(0)))


def setup(**kw):
    jcfg = jsmoke(NAME).replace(dtype="float32")
    tcfg = tsmoke(NAME).replace(dtype="float32", **kw)
    return jcfg, tcfg, tmodels.from_jax(tcfg, _tree(), device="cpu")


def vision_positions(b: int, n_text: int) -> np.ndarray:
    """(B, P + n_text, 3): patches at (0, row, col) of the grid, then text
    whose three streams run on together from max(grid)."""
    gh, gw = GRID
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    vis = np.stack([np.zeros_like(hh), hh, ww], -1).reshape(gh * gw, 3)
    text = np.repeat((max(gh, gw) + np.arange(n_text))[:, None], 3, 1)
    pos = np.concatenate([vis, text]).astype(np.int32)
    return np.broadcast_to(pos[None], (b,) + pos.shape).copy()


# ---------------------------------------------------------------------------
# Module level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_with_sections(dtype):
    """Three distinct streams drive the sections (2, 3, 3) of dh/2 = 8."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 9, 3)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = jlayers.apply_rope(jx, jnp.asarray(pos), 1e6, (2, 3, 3))
    got = tlayers.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(pos), 1e6, (2, 3, 3))
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # each section follows its own stream: a stream's move leaves the
    # channels of the other sections as they were
    moved = pos.copy()
    moved[..., 2] += 7
    got2 = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(moved),
                              1e6, (2, 3, 3))
    base = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6, (2, 3, 3))
    same = torch.isclose(got2, base)
    assert same[..., :5].all() and same[..., 8:13].all()
    assert not same[..., 5:8].all()
    with pytest.raises(ValueError, match="sum to 8"):
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           (2, 3, 2))
    with pytest.raises(ValueError, match="3\\) positions"):
        tlayers.apply_rope(torch.from_numpy(x),
                           torch.from_numpy(pos[..., 0]), 1e6, (2, 3, 3))


def test_default_positions_three_axes():
    jcfg, tcfg, _ = setup()
    want = jtfm.default_positions(jcfg, 2, 7)
    got = tmodels.default_positions(tcfg, 2, 7, device="cpu")
    assert tuple(got.shape) == (2, 7, 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off = np.array([3, 11], np.int32)
    want = jtfm.default_positions(jcfg, 2, 7, jnp.asarray(off))
    got = tmodels.default_positions(tcfg, 2, 7, torch.from_numpy(off))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
def test_prefill_with_vision_embeds_and_decode(use_pallas):
    jcfg, tcfg, tparams = setup(use_pallas=use_pallas)
    jparams = jax.tree.map(jnp.asarray, _tree())
    rng = np.random.default_rng(4)
    p = GRID[0] * GRID[1]
    toks = rng.integers(0, jcfg.vocab, (2, p + 20)).astype(np.int32)
    emb = rng.standard_normal((2, p, jcfg.d_model)).astype(np.float32)
    pos = vision_positions(2, 20)
    jcache = jmodels.init_cache(jcfg, 2, 64)
    tcache = tmodels.init_cache(tcfg, 2, 64, device="cpu")
    lj, jcache = jtfm.prefill(jparams, jcfg, jnp.asarray(toks), jcache,
                              positions=jnp.asarray(pos),
                              vision_embeds=jnp.asarray(emb))
    lt, tcache = tmodels.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                                 tcache, positions=torch.from_numpy(pos),
                                 vision_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    # the patch embeddings replace the first slots' token embeddings
    plain, _ = tmodels.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                               tmodels.init_cache(tcfg, 2, 64, device="cpu"),
                               positions=torch.from_numpy(pos))
    assert not torch.allclose(plain, lt)
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    for _ in range(5):
        lj, jcache = jmodels.decode_step(jparams, jcfg, jnp.asarray(tok),
                                         jcache)
        lt, tcache = tmodels.decode_step(tparams, tcfg,
                                         torch.from_numpy(tok).long(), tcache)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    assert tcache["pos"].tolist() == [p + 25] * 2


def test_prefill_paged_padded_three_axes():
    """The mixed step's chunk: 11 real tokens of a 16-token buffer after a
    5-token resident prefix, at 3-axis positions, against the
    reference's."""
    jcfg, tcfg, tparams = setup()
    jparams = jax.tree.map(jnp.asarray, _tree())
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (1, 16))
    toks = toks.astype(np.int32)
    tables = np.array([[3, 7, -1, -1]], np.int32)
    jcache = jmodels.init_cache(jcfg, 2, 64, layout="paged", num_pages=8,
                                page_size=16)
    tcache = tmodels.init_cache(tcfg, 2, 64, layout="paged", num_pages=8,
                                page_size=16, device="cpu")
    lj, jcache = jtfm.prefill_paged(
        jparams, jcfg, jnp.asarray(toks[:, :5]), jcache, jnp.asarray(tables),
        jnp.zeros((1,), jnp.int32), jnp.int32(1))
    lt, tcache = tmodels.prefill_paged(
        tparams, tcfg, torch.from_numpy(toks[:, :5]).long(), tcache,
        torch.from_numpy(tables), torch.zeros((1,), dtype=torch.int32), 1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    buf = np.zeros((1, 16), np.int32)
    buf[0, :11] = toks[0, 5:]
    lj, jcache = jtfm.prefill_paged_padded(
        jparams, jcfg, jnp.asarray(buf), jcache, jnp.asarray(tables),
        jnp.int32(5), jnp.int32(1), jnp.int32(11))
    lt, tcache = tmodels.prefill_paged_padded(
        tparams, tcfg, torch.from_numpy(buf).long(), tcache,
        torch.from_numpy(tables), torch.tensor(5, dtype=torch.int32),
        torch.tensor(1, dtype=torch.int32),
        torch.tensor(11, dtype=torch.int32))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    assert tcache["pos"].tolist() == [0, 16]


# ---------------------------------------------------------------------------
# Engine level (text only, as the reference's Engine serves the VLM)
# ---------------------------------------------------------------------------

def serve(eng, cls, max_new=8):
    rng = np.random.default_rng(3)
    reqs = [cls(prompt_len=n, max_new_tokens=max_new,
                prompt_tokens=rng.integers(0, 256, n).astype(np.int32))
            for n in (20, 45, 33, 60)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(len(r.output_tokens) == max_new for r in reqs)
    return [list(r.output_tokens) for r in reqs]


@functools.lru_cache(maxsize=None)
def reference_tokens(layout, mixed):
    jcfg, _, _ = setup()
    sched = dict(SCHED, mixed=mixed, prefill_chunk=16 if mixed else 0)
    return serve(Engine(jcfg, jax.tree.map(jnp.asarray, _tree()),
                        JSched(**sched), cache_layout=layout), JRequest)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "kernel"])
@pytest.mark.parametrize("layout,mixed", [("paged", False), ("ring", False),
                                          ("paged", True)],
                         ids=["paged", "ring", "mixed"])
def test_greedy_tokens_match_reference_engine(layout, mixed, use_pallas):
    _, tcfg, tparams = setup(use_pallas=use_pallas)
    sched = dict(SCHED, mixed=mixed, prefill_chunk=16 if mixed else 0)
    eng = TorchEngine(tcfg, tparams, SchedulerConfig(**sched),
                      cache_layout=layout, device="cpu")
    assert serve(eng, Request) == reference_tokens(layout, mixed)
    if mixed:
        assert eng.step_captures["mixed"] == 1
