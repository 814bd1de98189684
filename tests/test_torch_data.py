"""The port's token pipeline (``repro_torch/data``, a copy of
``repro/data``): ``batch_at`` equals the reference's, and twins of
``tests/test_data.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=64, global_batch=8, seed=3),
    dict(vocab=32000, seq_len=256, global_batch=8, seed=1),   # train_lm's
    dict(vocab=300, seq_len=16, global_batch=8, host_index=2, host_count=4),
    dict(vocab=50, seq_len=9, global_batch=2, zipf_a=1.5, mix=0.2)])
def test_batch_at_equals_the_reference(kw):
    ours, ref = TokenPipeline(DataConfig(**kw)), JTokenPipeline(
        JDataConfig(**kw))
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_batch_determinism():
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=3)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    for step in (0, 5, 17):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab=500, seq_len=32, global_batch=4)
    b = TokenPipeline(cfg).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_sharding_disjoint_and_covering():
    parts = []
    for h in range(4):
        c = DataConfig(vocab=1000, seq_len=16, global_batch=8,
                       host_index=h, host_count=4)
        parts.append(TokenPipeline(c).batch_at(3)["tokens"])
    assert all(p.shape == (2, 16) for p in parts)
    assert len({p.tobytes() for p in parts}) == 4


def test_prefetch_iteration_matches_batch_at():
    cfg = DataConfig(vocab=300, seq_len=16, global_batch=4, prefetch=2)
    p = TokenPipeline(cfg)
    it = iter(p)
    got = [next(it) for _ in range(3)]
    p.close()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], p.batch_at(i)["tokens"])


def test_restart_resumes_exact_stream():
    cfg = DataConfig(vocab=300, seq_len=16, global_batch=4)
    p = TokenPipeline(cfg)
    it = iter(p)
    for _ in range(5):
        next(it)
    state = p.state_dict()
    p.close()
    q = TokenPipeline(cfg)
    qit = iter(q)
    for _ in range(5):
        next(qit)
    q.load_state(state)
    resumed = next(iter(q))["tokens"]
    np.testing.assert_array_equal(resumed, p.batch_at(5)["tokens"])
    q.close()


def test_token_distribution_structured():
    cfg = DataConfig(vocab=1000, seq_len=256, global_batch=8)
    toks = TokenPipeline(cfg).batch_at(0)["tokens"].ravel()
    counts = np.bincount(toks, minlength=1000)
    top10 = counts[np.argsort(counts)[-10:]].sum()
    assert top10 > 0.2 * len(toks)          # zipfy head
    assert (counts > 0).sum() > 50          # but not degenerate
