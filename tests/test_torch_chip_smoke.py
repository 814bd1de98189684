"""chip_smoke.py's helpers, rehearsed on the CPU at small sizes: the
kernel-phase inputs, the bound and the library yardstick compute what
they claim, and the serve loop drives TorchEngine to completion.  The
script itself needs a GPU; this keeps its pieces from rotting."""
from pathlib import Path

import numpy as np
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


@pytest.mark.parametrize("s,t,causal,window", [(40, 40, True, -1),
                                               (40, 40, True, 9),
                                               (48, 30, False, -1)])
def test_flash_case_bound_and_yardstick(smoke, monkeypatch, s, t, causal,
                                        window):
    from repro_torch.kernels import flash_attention

    monkeypatch.setattr(smoke, "FLASH_HEADS", (4, 2, 32))
    gen = torch.Generator().manual_seed(0)
    args = smoke.flash_case(torch.float32, s, t, gen, torch.device("cpu"))
    assert [tuple(a.shape) for a in args] == [(1, s, 4, 32), (1, t, 2, 32),
                                              (1, t, 2, 32)]
    out = flash_attention(*args, causal=causal, window=window)
    sq, sk, sv, mask, is_causal = smoke.flash_sdpa_inputs(args, causal,
                                                          window)
    ref = torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask, is_causal=is_causal).transpose(1, 2)
    torch.testing.assert_close(ref, out, atol=2e-5, rtol=2e-5)
    # the valid-pair count the bound uses, against a brute-force mask
    i, j = np.arange(s)[:, None], np.arange(t)[None, :]
    valid = np.ones((s, t), bool)
    if causal:
        valid = j <= i
        if window > 0:
            valid &= j > i - window
    assert smoke.flash_valid_keys(s, t, causal, window) == valid.sum()
    ms, by = smoke.flash_bound(args, causal, window)
    t_ops = 4 * 32 * 4 * valid.sum() / smoke.F32_OPS_PER_S
    t_bytes = (2 * s * 4 * 32 + 2 * t * 2 * 32) * 4 / smoke.HBM_BYTES_PER_S
    assert ms == pytest.approx(1e3 * max(t_ops, t_bytes))
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


@pytest.mark.parametrize("slots,window", [(4096, -1), (1536, 512)])
def test_ring_case_bound_and_yardstick(smoke, slots, window):
    from repro_torch.kernels import decode_attention

    gen = torch.Generator().manual_seed(0)
    args = smoke.ring_case(torch.float32, slots, gen, torch.device("cpu"))
    q, k, _, kpos, q_pos = args
    assert tuple(q.shape) == (8, 1, 32, 128) and k.shape[1] == slots
    assert q_pos.tolist() == [c - 1 for c in smoke.CTX]
    # every slot holds the newest position of its residue class
    for r, c in enumerate(smoke.CTX):
        held = sorted(p for p in kpos[r].tolist() if p >= 0)
        assert held == list(range(max(c - slots, 0), c))
    valid = smoke.ring_valid(args, window)
    assert valid.sum(1).tolist() == smoke.needed_keys(window)
    live = torch.tensor([c > 0 for c in smoke.CTX])
    out = decode_attention(*args, window=window)
    h, hkv = q.shape[2], k.shape[2]
    sk = k.transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    sv = args[2].transpose(1, 2).repeat_interleave(h // hkv, dim=1)
    ref = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), sk, sv,
        attn_mask=valid[:, None, None, :]).transpose(1, 2)
    torch.testing.assert_close(ref[live], out[live], atol=2e-5, rtol=2e-5)
    ms, by = smoke.ring_bound(args, window)
    keys = sum(smoke.needed_keys(window))
    assert by == "bytes"
    assert ms > 1e3 * 2 * keys * 8 * 128 * 4 / smoke.HBM_BYTES_PER_S


@pytest.fixture
def small(smoke, monkeypatch):
    """chip_smoke's engine phases cut to tiny-agent sizes on the CPU."""
    from repro_torch import models
    from repro_torch.configs import get_config

    monkeypatch.setattr(smoke, "PARITY_LENS", [20, 33, 70, 100])
    monkeypatch.setattr(smoke, "PARITY_SCHED", dict(
        max_slots=4, num_pages=40, page_size=16, max_context=128))
    monkeypatch.setattr(smoke, "PARITY_SWA", (24, 32))
    monkeypatch.setattr(smoke, "MIGRATE_LEN", 70)
    cfg = get_config("tiny-agent").replace(dtype="float32")
    return cfg, models.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def test_parity_phase_runs_both_layouts(smoke, small, capsys):
    smoke.phase_parity(torch.device("cpu"), *small)
    out = capsys.readouterr().out
    assert out.count("greedy tokens equal across paged and ring") == 2


def test_migrate_phase_runs_every_direction(smoke, small, capsys):
    smoke.phase_migrate(torch.device("cpu"), *small)
    out = capsys.readouterr().out
    for d in ("ring->paged", "paged->ring after", "ring->ring"):
        assert d in out
    assert "paged->ring with window 24 refused: " in out
    assert "ring size 128 vs 64" in out


def test_expected_launches_follow_layout_and_flag(smoke, small):
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg, params = small
    for layout, use_pallas in smoke.LAYOUTS:
        eng = TorchEngine(cfg.replace(use_pallas=use_pallas), params,
                          SchedulerConfig(max_slots=2, num_pages=16,
                                          page_size=16, max_context=64),
                          cache_layout=layout, device="cpu")
        eng.decode_steps = 5
        assert set(smoke.expected_launches(eng, 3).values()) == {0}
        eng.device = torch.device("cuda")       # as the card would count
        want = smoke.expected_launches(eng, 3)
        n = cfg.n_layers
        if not use_pallas:
            assert set(want.values()) == {0}
        elif layout == "paged":
            assert want == {"paged_decode_attention": 5 * n,
                            "flash_attention": 0, "decode_attention": 0,
                            "ssm_scan": 0, "grouped_matmul": 0}
        else:
            assert want == {"paged_decode_attention": 0,
                            "flash_attention": 3 * n,
                            "decode_attention": 5 * n, "ssm_scan": 0,
                            "grouped_matmul": 0}


def test_expected_launches_of_a_hybrid(smoke):
    """A hymba ring engine launches the SSM scan once per layer per
    prefill, beside flash; without the flag nothing."""
    from repro_torch import models
    from repro_torch.configs import get_smoke
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = get_smoke("hymba-1.5b").replace(dtype="float32")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for use_pallas in (False, True):
        eng = TorchEngine(cfg.replace(use_pallas=use_pallas), params,
                          SchedulerConfig(max_slots=2, num_pages=16,
                                          page_size=16, max_context=64),
                          cache_layout="ring", device="cpu")
        eng.decode_steps = 7
        eng.device = torch.device("cuda")       # as the card would count
        n = cfg.n_layers
        assert smoke.expected_launches(eng, 2) == (
            {"paged_decode_attention": 0, "flash_attention": 2 * n,
             "decode_attention": 7 * n, "ssm_scan": 2 * n,
             "grouped_matmul": 0} if use_pallas
            else dict.fromkeys(smoke.KERNELS, 0))


def test_scan_phase_checks_and_bound(smoke, monkeypatch):
    """The SSM-scan phase on the CPU at small shapes: its cases run the
    wrapper (plain version here) against the plain version, the timed
    row has every key, and the bound counts what the call must move."""
    monkeypatch.setattr(smoke, "SCAN_CASES", [
        (1, 40, 3, 16, 64, 16, True, None, 0.0),
        (2, 20, 2, 8, 16, 8, False, 0.1, 0.5),
        (1, 20, 2, 80, 81, 8, False, 0.1, 0.3)])
    monkeypatch.setattr(smoke, "MLSTM_SCAN",
                        (1, 24, 2, 72, 73, 8, False, 0.1, 0.0))
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    row = smoke.phase_ssm_scan(torch.device("cpu"))
    assert row["name"] == "ssm_scan" and row["library_ms"] is None
    assert row["replaces"] == "src/repro/kernels/ssm_scan.py:69"
    assert row["max_abs_err"] == 0.0 and row["bound_by"] == "bytes"
    gen = torch.Generator().manual_seed(0)
    args = smoke.scan_case(torch.bfloat16, 1, 40, 3, 16, 64, True, None, 0.0,
                           gen, torch.device("cpu"))
    q, k, v, log_a, h0 = args
    assert q.stride(2) == 0 and tuple(q.shape) == (1, 40, 3, 16)
    assert (log_a <= 0).all() and not h0.any()
    assert smoke.stored_bytes(q) == 40 * 16 * 2
    assert smoke.stored_bytes(v) == 40 * 3 * 64 * 2
    nbytes = 2 * 40 * 16 * 2 + 2 * 40 * 3 * 64 * 2 + 40 * 3 * 4 \
        + 2 * 3 * 16 * 64 * 4
    pairs = 2 * (16 * 17 // 2) + 8 * 9 // 2        # chunks of 16, 16, 8
    ops = 3 * (2 * 80 * pairs + 4 * 40 * 16 * 64)
    ms, by = smoke.scan_bound(args, 16)
    assert ms == pytest.approx(1e3 * max(nbytes / smoke.HBM_BYTES_PER_S,
                                         ops / smoke.BF16_OPS_PER_S))
    assert by == "bytes"


def test_hymba_phases_run_on_cpu(smoke, monkeypatch, capsys):
    """chip_smoke's hymba parity and migration phases at hymba-smoke
    sizes on the CPU."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "PARITY_LENS", [20, 70, 130])
    monkeypatch.setattr(smoke, "PARITY_SCHED", dict(
        max_slots=3, num_pages=40, page_size=16, max_context=160))
    monkeypatch.setattr(smoke, "PARITY_SWA", (16, 8))
    monkeypatch.setattr(smoke, "MIGRATE_LEN", 70)
    cfg = get_smoke("hymba-1.5b").replace(dtype="float32")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    smoke.phase_parity(torch.device("cpu"), cfg, params,
                       [("ring", True), ("ring", False)], "hymba smoke")
    smoke.phase_hymba_migrate(torch.device("cpu"),
                              cfg.replace(window=16, attn_chunk=8), params)
    out = capsys.readouterr().out
    assert out.count("greedy tokens equal across ring, with and without "
                     "its kernels") == 2
    assert "hymba ring->ring after 4 tokens" in out


@pytest.mark.parametrize("name", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_expected_launches_of_moe(smoke, name):
    """An MoE engine launches grouped_matmul three times per MoE layer per
    forward in either layout (kimi's dense first layer none), beside the
    layout's attention kernels; without the flag nothing."""
    from repro_torch import models
    from repro_torch.configs import get_smoke
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = get_smoke(name).replace(dtype="float32")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert smoke.moe_layers(cfg) == 2 and cfg.n_layers == (
        2 if name == "arctic-480b" else 3)
    for layout in ("paged", "ring"):
        for use_pallas in (False, True):
            eng = TorchEngine(cfg.replace(use_pallas=use_pallas), params,
                              SchedulerConfig(max_slots=2, num_pages=16,
                                              page_size=16, max_context=64),
                              cache_layout=layout, device="cpu")
            eng.decode_steps = 7
            eng.device = torch.device("cuda")   # as the card would count
            want = smoke.expected_launches(eng, 3)
            n = cfg.n_layers
            if not use_pallas:
                assert set(want.values()) == {0}
                continue
            assert want["grouped_matmul"] == 3 * 2 * (3 + 7)
            if layout == "paged":
                assert want["paged_decode_attention"] == 7 * n
            else:
                assert (want["flash_attention"],
                        want["decode_attention"]) == (3 * n, 7 * n)


def test_grouped_matmul_phase_checks_and_bound(smoke, monkeypatch):
    """The grouped_matmul phase on the CPU at small widths: its cases run
    the wrapper (plain version here) against the plain version, the
    timed row has every key, and the bound counts the live experts'
    weights, the live rows and all of the output."""
    monkeypatch.setattr(smoke, "ARCTIC_EXPERTS", (32, 48, 40))
    monkeypatch.setattr(smoke, "KIMI_EXPERTS", (48, 40, 24))
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    row = smoke.phase_grouped_matmul(torch.device("cpu"))
    assert row["name"] == "grouped_matmul" and row["route"] == "cuda"
    assert row["replaces"] == "src/repro/kernels/grouped_matmul.py:59"
    assert row["max_abs_err"] == 0.0 and row["library_ms"] == 1.0
    assert set(row) == {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cpu")
    counts = smoke.routed_counts(8, 128, 8, gen, dev)
    assert counts.dtype == torch.int32 and int(counts.sum()) == 16
    assert int((counts > 0).sum()) <= 16
    full = smoke.routed_counts(1024, 128, 24, gen, dev)
    assert int(full.max()) <= 24 and 1900 < int(full.sum()) <= 2048
    counts = torch.tensor([0, 3, 8, 0], dtype=torch.int32)
    x = smoke.gm_buffer(torch.bfloat16, counts, 8, 16, gen, dev)
    assert not x[0].any() and not x[1, 3:].any() and x[1, :3].all()
    w = smoke.gm_weights(torch.bfloat16, 4, 16, 24, gen, dev)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (4, 16, 24)
    ms, by = smoke.gm_bound(x, w, counts)
    nbytes = (2 * 16 * 24 + 11 * 16 + 4 * 8 * 24) * 2 + 4 * 4
    ops = 2 * 11 * 16 * 24
    assert ms == pytest.approx(1e3 * max(nbytes / smoke.HBM_BYTES_PER_S,
                                         ops / smoke.BF16_OPS_PER_S))
    assert by == "bytes"
    err = smoke.check_gm(x, w, counts, "rehearsal")
    assert err == 0.0
    # the band grows with |y|: one bf16 unit at 4 passes, 0.05 at 1 not
    want = torch.tensor([4.0, 1.0, 0.0])
    assert smoke.gm_errors(torch.tensor([4.03125, 1.0, 0.0]), want) == \
        pytest.approx((0.03125, 0.03125 / 5))
    assert smoke.gm_errors(torch.tensor([4.0, 1.05, 0.0]), want)[1] == \
        pytest.approx(0.025)


def test_arctic_parity_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """chip_smoke's arctic parity phase at arctic-smoke sizes on the CPU:
    both layouts, kernels on and off, full attention and a window."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "PARITY_LENS", [20, 45])
    monkeypatch.setattr(smoke, "PARITY_SCHED", dict(
        max_slots=2, num_pages=24, page_size=16, max_context=64))
    monkeypatch.setattr(smoke, "PARITY_SWA", (24, 8))
    cfg = get_smoke("arctic-480b").replace(dtype="float32")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    smoke.phase_parity(torch.device("cpu"), cfg, params,
                       label="arctic smoke")
    out = capsys.readouterr().out
    assert out.count("arctic smoke, f32") == 2
    assert out.count("greedy tokens equal across paged and ring") == 2


@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_expected_grouped_matmul_calls_follow_prefill_forwards(
        smoke, monkeypatch, layout):
    """A token budget smaller than the prompts splits the paged layout's
    prefills into chunks, each a forward; the ring layout prefills each
    prompt whole.  The expected grouped_matmul launches, from the counted
    prefill work and decode steps, equal the wrapper's calls on the CPU
    (where it runs its plain version and launches nothing)."""
    from repro_torch import models
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    calls = []
    real = moe.grouped_matmul
    monkeypatch.setattr(moe, "grouped_matmul",
                        lambda *a: calls.append(1) or real(*a))
    cfg = get_smoke("arctic-480b").replace(dtype="float32", use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = TorchEngine(cfg, params, SchedulerConfig(
        max_slots=3, num_pages=40, page_size=16, max_context=128,
        max_batch_tokens=64), cache_layout=layout, device="cpu")
    reqs = smoke.make_requests([50, 40, 30], 4, cfg.vocab, seed=3)
    res = smoke.served_counts(eng, reqs, smoke.launch_counts())
    forwards = res["prefill_forwards"]
    # paged: 50 + 14 of 40 in the first step, 26 + 30 in the second
    assert forwards == (4 if layout == "paged" else 3)
    eng.device = torch.device("cuda")           # as the card would count
    want = smoke.expected_launches(eng, forwards)["grouped_matmul"]
    assert want == len(calls) == 3 * 2 * (forwards + eng.decode_steps)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126flash_attention_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_126flash_attention_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118split_merge_kernelIfEEvPKfPK6float2PT_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118split_merge_kernelIfEEvPKfPK6float2PT_ii
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 380 bytes cmem[0]
"""


def test_ptxas_entries_reads_registers_and_spills(smoke):
    entries = smoke.ptxas_entries(PTXAS_LOG)
    assert [e[1:] for e in entries] == [(128, 0), (30, 12)]
    assert "flash_attention_mma_kernel" in entries[0][0]
    assert "split_merge_kernel" in entries[1][0]
    assert all(any(k in e[0] for k in smoke.NEW_KERNELS) for e in entries)
    assert smoke.ptxas_entries("nvcc: nothing compiled") == []


@pytest.mark.parametrize("s,t,causal,window", [(400, 200, True, 64),
                                               (1100, 700, True, 256),
                                               (77, 77, True, 5),
                                               (200, 90, False, -1)])
def test_flash_live_rows_against_brute_force(smoke, s, t, causal, window):
    i, j = np.arange(s)[:, None], np.arange(t)[None, :]
    valid = np.ones((s, t), bool)
    if causal:
        valid = j <= i
        if window > 0:
            valid &= j > i - window
    live = smoke.flash_live_rows(s, t, causal, window)
    assert (live == valid.any(1)).all()
    if (s, t, window) == (1100, 700, 256):        # chip_smoke's edge case
        assert live.sum() == 955


def test_flash_edge_cases_run_on_cpu(smoke, monkeypatch):
    """check_flash over chip_smoke's edge cases at small heads on the CPU,
    where the wrapper takes the plain version: rows with no valid key are
    zeroed by a stand-in for the kernel, the others compared."""
    from repro_torch.kernels import flash_attention_plain

    def kernel(q, k, v, *, causal=True, window=-1):
        out = flash_attention_plain(q, k, v, causal=causal, window=window)
        live = smoke.flash_live_rows(q.shape[1], k.shape[1], causal, window)
        out[:, ~torch.from_numpy(live)] = 0
        return out

    monkeypatch.setattr(smoke, "flash_attention", kernel)
    gen = torch.Generator().manual_seed(0)
    small = (4, 2, 32)
    for _, b, s, t, causal, window in smoke.EDGE_FLASH_CASES:
        err = smoke.check_flash(torch.float32, small, b, s, t, causal,
                                window, gen, torch.device("cpu"))
        assert err == 0.0
    monkeypatch.setattr(smoke, "flash_attention", flash_attention_plain)
    with pytest.raises(AssertionError, match="no valid key is not zero"):
        smoke.check_flash(torch.float32, small, 1, 300, 120, True, 64, gen,
                          torch.device("cpu"))


def test_ring_edge_cases_plan_as_documented(smoke):
    """The phase's rings split as its comment says: 16 ranges of 256 at
    4096 slots, a ragged last range at 3000, one range at 64, ranges of
    64 for hymba's 1000-slot ring."""
    from repro_torch.kernels.decode_attention import decode_splits

    b = len(smoke.CTX)
    assert decode_splits(b, smoke.RING_HEADS[0], 4096) == (16, 256)
    assert decode_splits(b, smoke.HYMBA_RING_HEADS[0], 4096) == (16, 256)
    splits, per = decode_splits(b, smoke.RING_HEADS[0], 3000)
    assert 3000 % per and splits == 12
    assert decode_splits(b, smoke.RING_HEADS[0], 64)[0] == 1
    assert decode_splits(b, smoke.HYMBA_RING_HEADS[0], 1000) == (16, 64)
    assert (64, -1) in smoke.RING_CASES and (3000, -1) in smoke.RING_CASES
    assert (2048, 1024) in smoke.HYMBA_RING_CASES


def test_prefill_profile_runs_on_cpu(smoke, monkeypatch, capsys):
    """profile_prefill on a tiny ring engine: one prompt prefilled twice,
    its device rows (faked here: the CPU has no device time) summed and
    flash's share printed; the engine ends idle."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = get_config("tiny-agent").replace(dtype="float32")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = TorchEngine(cfg, params, SchedulerConfig(
        max_slots=2, num_pages=16, page_size=16, max_context=128),
        cache_layout="ring", device="cpu")
    monkeypatch.setattr(smoke, "device_rows", lambda prof: [
        (750.0, 2, "void flash_attention_mma_kernel<128>(...)"),
        (2250.0, 10, "gemm")])
    smoke.profile_prefill(eng, 40, "serve ring")
    out = capsys.readouterr().out
    assert "prefill of one 40-token prompt: device busy 3.00 ms" in out
    assert "flash_attention 0.750 ms (25.0% of the device time" in out
    assert not eng.busy and eng.prefill_steps == 2


def test_time_ranges_restores_the_planner(smoke, monkeypatch, capsys):
    """time_ranges on the CPU at small heads: each range length is held
    to the plain version and timed (faked here), one line per (heads,
    contexts), and decode_splits is the planner again afterwards."""
    import sys as _sys

    from repro_torch.kernels import decode_attention

    planner = _sys.modules[decode_attention.__module__]
    plan = planner.decode_splits
    for name, heads in (("RING_HEADS", (2, 4, 32)),
                        ("HYMBA_RING_HEADS", (1, 5, 32)),
                        ("ARCTIC_RING_HEADS", (1, 7, 32))):
        monkeypatch.setattr(smoke, name, heads)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    smoke.time_ranges(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert planner.decode_splits is plan
    out = capsys.readouterr().out
    assert out.count("ranges of 512/256/128 slots: 1.0000 / 1.0000 / "
                     "1.0000 ms") == 6
    assert out.count("4096-slot ring, serve contexts") == 3
    assert out.count("max |kernel - plain| 0.000e+00") == 18
    args = smoke.ring_case(torch.float32, 4096, torch.Generator(),
                           torch.device("cpu"), heads=(1, 1, 32),
                           ctx=smoke.SERVE_CTX)
    assert args[4].tolist() == [c - 1 for c in smoke.SERVE_CTX]


@pytest.mark.parametrize("heads", [(8, 8, 112), (8, 16, 120), (8, 6, 120)])
def test_kernel_case_at_new_heads(smoke, heads):
    """kernel_case at kimi-k2's heads and at the shapes no ported config
    uses yet: the pool and q take the heads, and the bound counts the
    bytes of the real head dim."""
    from repro_torch.kernels import paged_decode_attention

    hkv, g, dh = heads
    gen = torch.Generator().manual_seed(0)
    args = smoke.kernel_case(torch.float32, 128, gen, torch.device("cpu"),
                             heads)
    q, kp, _, bt, ctx = args
    assert tuple(q.shape) == (8, 1, hkv * g, dh)
    assert tuple(kp.shape[1:]) == (128, hkv, dh)
    assert torch.equal(bt[6], bt[7]) and (bt[5] == -1).all()
    out = paged_decode_attention(*args)
    assert torch.equal(out[6], out[7])
    ms, by = smoke.bound(args, -1)
    keys = sum(smoke.CTX)
    assert by == "bytes"
    assert ms > 1e3 * 2 * keys * hkv * dh * 4 / smoke.HBM_BYTES_PER_S
    assert heads == smoke.KIMI_HEADS or heads in smoke.UNSERVED_HEADS


def test_paged_kernel_phase_on_cpu(smoke, monkeypatch, capsys):
    """phase_kernels at short contexts on the CPU, where the wrapper takes
    its plain version: every head shape, page and window is checked (the
    ctx 0 row zero, rows 6 and 7 identical), three times are logged and
    the JSON row has every key."""
    from repro_torch.kernels import paged_decode_attention_plain

    def kernel(*args, window=-1):
        out = paged_decode_attention_plain(*args, window=window)
        out[args[4] == 0] = 0                     # as the kernel writes it
        return out

    monkeypatch.setattr(smoke, "paged_decode_attention", kernel)
    monkeypatch.setattr(smoke, "CTX", [300, 257, 129, 100, 17, 0, 200, 200])
    monkeypatch.setattr(smoke, "SHARED_TOKENS", 128)
    monkeypatch.setattr(smoke, "UNSERVED_HEADS", [(2, 12, 24)])
    for name in ("PAGED_HEADS", "ARCTIC_PAGED_HEADS", "KIMI_HEADS"):
        hkv, g, dh = getattr(smoke, name)
        monkeypatch.setattr(smoke, name, (2, g, dh // 4))
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    row = smoke.phase_kernels(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("paged_decode_attention torch.") == 2 * 4 * 2 * 2
    assert "Hkv=2 G=12 dh=24 page 16 window 512" in out
    assert out.count("kernel 1.0000 ms") == 3
    assert row["name"] == "paged_decode_attention" and row["ms"] == 1.0
    assert row["max_abs_err"] == 0.0 and row["bound_by"] == "bytes"
    assert set(row) == {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}


def test_kimi_parity_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """chip_smoke's kimi parity phase at kimi-smoke sizes on the CPU:
    both layouts, kernels on and off, full attention and a window."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "PARITY_LENS", [20, 45])
    monkeypatch.setattr(smoke, "PARITY_SCHED", dict(
        max_slots=2, num_pages=24, page_size=16, max_context=64))
    monkeypatch.setattr(smoke, "PARITY_SWA", (24, 8))
    cfg = get_smoke("kimi-k2-1t-a32b").replace(dtype="float32", n_layers=1)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    smoke.phase_parity(torch.device("cpu"), cfg, params, label="kimi smoke")
    out = capsys.readouterr().out
    assert out.count("kimi smoke, f32") == 2
    assert out.count("greedy tokens equal across paged and ring") == 2


@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_expected_launches_of_kimi_serve(smoke, layout):
    """The kimi serve phase's counts at full width, 2 of 61 layers (the
    dense first layer and one MoE layer): the layout's attention kernels
    twice per decode step (ring: flash twice per prefill), grouped_matmul
    three times per forward of its one MoE layer."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config

    cfg = get_config("kimi-k2-1t-a32b").replace(n_layers=2, use_pallas=True)
    assert smoke.moe_layers(cfg) == 1
    assert cfg.d_head == 112 and cfg.n_heads // cfg.n_kv_heads == 8
    assert smoke.KIMI_HEADS == (cfg.n_kv_heads, 8, cfg.d_head)
    assert smoke.KIMI_FLASH_HEADS == (cfg.n_heads, cfg.n_kv_heads,
                                      cfg.d_head)
    eng = SimpleNamespace(cfg=cfg, device=torch.device("cuda"),
                          cache_layout=layout, decode_steps=63)
    want = smoke.expected_launches(eng, 10 if layout == "paged" else 8)
    if layout == "paged":
        assert want == {"paged_decode_attention": 126, "flash_attention": 0,
                        "decode_attention": 0, "ssm_scan": 0,
                        "grouped_matmul": 3 * (10 + 63)}
    else:
        assert want == {"paged_decode_attention": 0, "flash_attention": 16,
                        "decode_attention": 126, "ssm_scan": 0,
                        "grouped_matmul": 3 * (8 + 63)}


def test_decode_profile_runs_on_cpu(smoke, monkeypatch, capsys):
    """profile_decode on a tiny paged engine: four decode steps profiled,
    the device rows (faked: the CPU has no device time) summed, and the
    decode attention kernels (split and merge) reported apart."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import TorchEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = get_config("tiny-agent").replace(dtype="float32")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = TorchEngine(cfg, params, SchedulerConfig(
        max_slots=8, num_pages=300, page_size=16, max_context=640),
        device="cpu")
    monkeypatch.setattr(smoke, "device_rows", lambda prof: [
        (400.0, 8, "void paged_split_kernel<__nv_bfloat16, 128, 4>(...)"),
        (200.0, 8, "void split_merge_kernel<__nv_bfloat16>(...)"),
        (3400.0, 40, "gemm")])
    smoke.profile_decode(eng, 10.0, "serve")
    out = capsys.readouterr().out
    assert "decode step: device busy 1.00 ms of 10.00 ms" in out
    assert "decode attention kernels (split and merge): 0.150 ms/step in " \
           "4 calls/step" in out
    assert not eng.busy


def test_scan_case_scales_wide_heads(smoke):
    """Past dk 64 (mLSTM's widths) q and k are N(0, 1) / sqrt(dk), as
    mLSTM scales them, so y stays O(1) and the bf16 band means what it
    means at hymba's widths."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, log_a, h0 = smoke.scan_case(torch.float32, 1, 64, 2, 512, 513,
                                         False, 0.1, 0.0, gen,
                                         torch.device("cpu"))
    assert tuple(v.shape) == (1, 64, 2, 513) and tuple(q.shape) == (1, 64,
                                                                    2, 512)
    assert 0.03 < q.std().item() < 0.06             # 512 ** -0.5 = 0.044
    y, _ = smoke.ssm_scan_plain(q, k, v, log_a, h0, chunk=64)
    assert y.abs().max().item() < 2.0
    assert smoke.MLSTM_SCAN[3:5] == (512, 513)
