"""chip_smoke.py's helpers, rehearsed on the CPU at small sizes: the
kernel-phase inputs, the bound and the library yardstick compute what
they claim, and the serve loop drives TorchEngine to completion.  The
script itself needs a GPU; this keeps its pieces from rotting."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    # the serve loop synchronises the card after each step
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return chip_smoke


@pytest.mark.parametrize("page,window", [(128, -1), (16, 512)])
def test_kernel_case_bound_and_yardstick(smoke, page, window):
    from repro_torch.kernels import paged_decode_attention

    gen = torch.Generator().manual_seed(0)
    args = smoke.kernel_case(torch.float32, page, gen, torch.device("cpu"))
    q, kp, _, bt, ctx = args
    assert tuple(q.shape) == (8, 1, 32, 128) and kp.shape[1] == page
    assert ctx.tolist() == smoke.CTX and (bt[5] == -1).all()
    assert torch.equal(bt[6], bt[7])
    out = paged_decode_attention(*args, window=window)
    assert torch.equal(out[6], out[7])
    sq, sk, sv, mask = smoke.sdpa_inputs(args, window)
    ref = torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask).transpose(1, 2)
    live = ctx > 0
    torch.testing.assert_close(ref[live], out[live], atol=2e-5, rtol=2e-5)
    ms, by = smoke.bound(args, window)
    keys = sum(smoke.needed_keys(window))
    assert by == "bytes"
    assert ms > 1e3 * 2 * keys * 8 * 128 * 4 / smoke.HBM_BYTES_PER_S


def test_serve_loop_finishes_every_request(smoke):
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode_attention
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = get_config("tiny-agent").replace(use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = TorchEngine(cfg, params, SchedulerConfig(
        max_slots=4, num_pages=32, page_size=16, max_context=128),
        device="cpu")
    reqs = smoke.make_requests([20, 33, 47, 5], 6, cfg.vocab, seed=3)
    launches = paged_decode_attention.launches
    res = smoke.serve(eng, reqs)
    assert paged_decode_attention.launches == launches   # CPU: no kernel
    assert res["decode_tokens"] == sum(r.max_new_tokens - 1 for r in reqs)
    assert res["times"]["decode"] > 0 and eng.decode_steps > 0
