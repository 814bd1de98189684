"""chip_smoke.py's helpers, rehearsed on the CPU at small sizes: the
kernel-phase inputs, the bound and the library yardstick compute what
they claim, and the serve loop drives TorchEngine to completion.  The
script itself needs a GPU; this keeps its pieces from rotting."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_threads import one_torch_thread  # noqa: E402,F401

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
        assert set(smoke.expected_launches(eng, 3, 5).values()) == {0}
        eng.device = torch.device("cuda")       # as the card would count
        want = smoke.expected_launches(eng, 3, 5)
        n = cfg.n_layers
        if not use_pallas:
            assert set(want.values()) == {0}
        elif layout == "paged":
            # a prefill chunk of more than one token on paged flash, of
            # one on paged decode
            assert want == {"paged_decode_attention": 5 * n,
                            "paged_flash_attention": 3 * n,
                            "flash_attention": 0, "decode_attention": 0,
                            "ssm_scan": 0, "grouped_matmul": 0}
            assert smoke.expected_launches(eng, 3, 5, 2, 1) == {
                "paged_decode_attention": 8 * n,
                "paged_flash_attention": 4 * n, "flash_attention": 0,
                "decode_attention": 0, "ssm_scan": 0, "grouped_matmul": 0}
        else:
            assert want == {"paged_decode_attention": 0,
                            "paged_flash_attention": 0,
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
        eng.device = torch.device("cuda")       # as the card would count
        n = cfg.n_layers
        assert smoke.expected_launches(eng, 2, 7) == (
            {"paged_decode_attention": 0, "paged_flash_attention": 0,
             "flash_attention": 2 * n, "decode_attention": 7 * n,
             "ssm_scan": 2 * n, "grouped_matmul": 0} if use_pallas
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
    monkeypatch.setattr(smoke, "MLSTM_13B_SCAN",
                        (1, 24, 2, 520, 1030, 8, False, 0.1, 0.0))
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    row, past = smoke.phase_ssm_scan(torch.device("cpu"))
    assert past["name"] == "ssm_scan at xLSTM's 1.3B width"
    assert set(past) == set(row) | {"shapes"}
    assert past["ms"] == 1.0 and past["library_ms"] is None
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
            eng.device = torch.device("cuda")   # as the card would count
            want = smoke.expected_launches(eng, 3, 7)
            n = cfg.n_layers
            if not use_pallas:
                assert set(want.values()) == {0}
                continue
            assert want["grouped_matmul"] == 3 * 2 * (3 + 7)
            if layout == "paged":
                assert want["paged_decode_attention"] == 7 * n
                # two mixed steps: decode rows and a chunk, two forwards
                mixed = smoke.expected_launches(eng, 3, 7, 2)
                assert mixed["grouped_matmul"] == 3 * 2 * (3 + 7 + 2 * 2)
                assert mixed["paged_decode_attention"] == 9 * n
                assert mixed["paged_flash_attention"] == 5 * n
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
    want = smoke.expected_launches(eng, forwards,
                                   res["runs"]["decode"])["grouped_matmul"]
    assert want == len(calls) == 3 * 2 * (forwards + eng.decode_steps)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_tma_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_tma_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118split_merge_kernelIfEEvPKfPK6float2PT_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118split_merge_kernelIfEEvPKfPK6float2PT_ii
    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 380 bytes cmem[0]
"""


def test_ptxas_entries_reads_registers_and_spills(smoke):
    entries = smoke.ptxas_entries(PTXAS_LOG)
    assert [e[1:] for e in entries] == [(168, 0), (30, 12)]
    assert "flash_fwd_tma_kernel" in entries[0][0]
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
        (750.0, 2, "void flash_fwd_tma_kernel<128>(...)"),
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


@pytest.mark.parametrize("heads", [(8, 8, 112), (8, 16, 120), (8, 6, 120),
                                   (8, 2, 256), (8, 3, 128), (8, 4, 100)])
def test_kernel_case_at_new_heads(smoke, heads):
    """kernel_case at kimi-k2's heads, at the shapes no ported config
    uses yet and at those the reference pads (Gemma 3 12B's dh 256,
    Llama 3.2 3B's G 3, dh 100): the pool and q take the heads, and the
    bound counts the bytes of the real head dim."""
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
    assert (heads == smoke.KIMI_HEADS or heads in smoke.UNSERVED_HEADS
            or heads in smoke.WIDE_HEADS)


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
    # the shapes the reference pads: dh 256 (two loads a lane in f32), G
    # 3 and a dh that is not a multiple of 8
    monkeypatch.setattr(smoke, "WIDE_HEADS", [(1, 2, 256), (2, 3, 36)])
    # past 256: column blocks, one of them short and element by element
    monkeypatch.setattr(smoke, "PAST_HEADS", [(1, 2, 300)])
    monkeypatch.setattr(smoke, "DH1024_HEADS", (1, 1, 520))
    for name in ("PAGED_HEADS", "ARCTIC_PAGED_HEADS", "KIMI_HEADS"):
        hkv, g, dh = getattr(smoke, name)
        monkeypatch.setattr(smoke, name, (2, g, dh // 4))
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    row, past = smoke.phase_kernels(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("paged_decode_attention torch.") == 2 * 8 * 2 * 2
    assert "Hkv=2 G=12 dh=24 page 16 window 512" in out
    assert "Hkv=1 G=2 dh=256 page 128 window -1" in out
    assert "Hkv=2 G=3 dh=36 page 16 window 512" in out
    assert "Hkv=1 G=1 dh=520 page 16 window 512" in out
    assert out.count("kernel 1.0000 ms") == 6
    assert past["name"] == "paged_decode_attention past dh 256"
    assert past["shapes"] == ["Hkv=1 G=2 dh=300", "Hkv=1 G=1 dh=520"]
    assert past["max_abs_err"] == 0.0 and past["ms"] == 1.0
    assert row["name"] == "paged_decode_attention" and row["ms"] == 1.0
    assert row["max_abs_err"] == 0.0 and row["bound_by"] == "bytes"
    assert set(row) == {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "shapes"}
    assert row["shapes"][-2:] == ["Hkv=1 G=2 dh=256", "Hkv=2 G=3 dh=36"]


def test_paged_flash_phase_on_cpu(smoke, monkeypatch, capsys):
    """phase_paged_flash at a short chunk on the CPU, where the wrapper
    takes its plain version (the pad rows zeroed, as the kernel writes
    them): every case in both dtypes is checked (twice, equal), each bf16
    case timed beside the gather path and SDPA over the gathered K/V, and
    both JSON rows have every key."""
    from repro_torch.kernels import paged_flash_attention_plain
    from repro_torch.kernels.paged_flash_attention import live_rows

    def kernel(*args, window=-1):
        out = paged_flash_attention_plain(*args, window=window)
        out[~live_rows(args[3], args[4], args[1].shape[1], window)] = 0
        return out

    monkeypatch.setattr(smoke, "paged_flash_attention", kernel)
    monkeypatch.setattr(smoke, "CHUNK_START", 40)
    monkeypatch.setattr(smoke, "CHUNK_ROWS", 24)
    monkeypatch.setattr(smoke, "CHUNK_WIDTH", 128)
    monkeypatch.setattr(smoke, "PAGED_FLASH_CASES", [
        ("agent-7b", (2, 4, 32), 16, -1), ("window", (2, 2, 32), 16, 20),
        ("pages of 8", (1, 8, 24), 8, -1),
        ("agent-7b at d_head 512", (1, 2, 300), 16, -1),
        ("dh 100", (2, 2, 25), 16, -1)])
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    row, past = smoke.phase_paged_flash(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("paged_flash_attention torch.") == 2 * 5
    assert "(8 pad rows), live rows" in out
    assert out.count("SDPA over the gathered contiguous K/V 1.0000 ms") == 5
    assert "the gather path it replaces (paged_view + attention_cached)" \
        in out
    assert row["name"] == "paged_flash_attention" and row["ms"] == 1.0
    assert row["max_abs_err"] == 0.0
    assert set(row) == set(past) == {
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shapes"}
    assert past["name"] == "paged_flash_attention past dh 256"
    assert past["shapes"] == ["Hkv=1 G=2 dh=300"]
    # the bound: the valid pairs' operations at the bf16 rate against the
    # live keys' K/V, q, out, table and q_pos bytes
    args = smoke.paged_flash_case(torch.bfloat16, (2, 4, 32), 16,
                                  torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    pairs, keys = sum(40 + i + 1 for i in range(16)), 40 + 16
    t_ops = 4 * 32 * 8 * pairs / smoke.BF16_OPS_PER_S
    t_bytes = (2 * keys * 2 * 32 * 2 + 2 * 24 * 8 * 32 * 2 + 8 * 4
               + 24 * 4) / smoke.HBM_BYTES_PER_S
    assert smoke.paged_flash_bound(args, -1) == (
        pytest.approx(1e3 * max(t_ops, t_bytes)),
        "bytes" if t_bytes >= t_ops else "operations")



@pytest.fixture
def tools(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))


def test_attention_times_paged_cases_are_the_smokes(smoke, tools):
    """tools/attention_times.py's bf16 chunk cases and chunk shape are
    chip_smoke.py's PAGED_FLASH_CASES and CHUNK_*, so the tool times the
    smoke's cases."""
    import attention_times as at

    assert sorted((c[2], c[3], c[4]) for c in at.PAGED_FLASH_CASES
                  if c[1] == "bfloat16" and len(c) == 5) == sorted(
        (heads, page, window)
        for _, heads, page, window in smoke.PAGED_FLASH_CASES)
    assert (at.CHUNK_START, at.CHUNK_ROWS, at.CHUNK_PAD, at.CHUNK_WIDTH) \
        == (smoke.CHUNK_START, smoke.CHUNK_ROWS, smoke.CHUNK_PAD,
            smoke.CHUNK_WIDTH)


def test_paged_serve_times_traffic_is_the_smokes(smoke, tools):
    """tools/paged_serve_times.py's copies of the smoke's serve traffic
    are equal to it: the prompts' lengths, the schedules, the system
    prompt, and the tokens of both waves (serve mixed's seeds 3, 9 and
    10)."""
    import paged_serve_times as ps
    from repro_torch.configs import get_config
    from repro_torch.core.types import Request

    assert ps.SERVE_LENS == smoke.SERVE_LENS
    assert ps.SERVE_SCHED == smoke.SERVE_SCHED
    assert ps.MIXED_SCHED == smoke.MIXED_SCHED
    assert ps.SYSTEM_PROMPT == smoke.SYSTEM_PROMPT
    vocab = get_config(ps.MODEL).vocab
    suffixes = np.random.default_rng(9).integers(64, 257, 8)
    assert ps.SUFFIXES == suffixes.tolist()
    for got, want in (
            (ps.requests(Request, vocab, ps.SERVE_LENS, 3),
             smoke.make_requests(smoke.SERVE_LENS, ps.NEW, vocab, seed=3)),
            (ps.requests(Request, vocab, ps.SUFFIXES, 10, ps.SYSTEM_PROMPT),
             smoke.shared_prefix_requests(smoke.SYSTEM_PROMPT, suffixes,
                                          ps.NEW, vocab, seed=10))):
        assert [r.prompt_len for r in got] == [r.prompt_len for r in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.prompt_tokens, b.prompt_tokens)

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
                          cache_layout=layout)
    want = smoke.expected_launches(eng, 10 if layout == "paged" else 8, 63)
    if layout == "paged":
        assert want == {"paged_decode_attention": 126,
                        "paged_flash_attention": 20, "flash_attention": 0,
                        "decode_attention": 0, "ssm_scan": 0,
                        "grouped_matmul": 3 * (10 + 63)}
    else:
        assert want == {"paged_decode_attention": 0,
                        "paged_flash_attention": 0, "flash_attention": 16,
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
    assert "decode step (eager): device busy 1.00 ms of 10.00 ms" in out
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


def test_mixed_parity_phase_runs_on_cpu(smoke, small, monkeypatch, capsys):
    """The mixed parity phase at tiny-agent sizes: the serialized eager
    run, the mixed step and the mixed step with a PrefixCache give equal
    tokens, kernels on and off; the cached run finds wave 2's prefix."""
    monkeypatch.setattr(smoke, "MIXED_PREFIX", 32)
    monkeypatch.setattr(smoke, "MIXED_SUFFIXES", [10, 25, 40, 7])
    monkeypatch.setattr(smoke, "MIXED_CHUNK", 16)
    smoke.phase_mixed_parity(torch.device("cpu"), *small)
    out = capsys.readouterr().out
    assert out.count("greedy tokens equal across ['serialized eager', "
                     "'mixed graph', 'mixed graph cached']") == 2
    assert out.count("wave 2 prefilled 114 of 210 prompt tokens (96 "
                     "cached)") == 2


def test_serve_mixed_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """The serve mixed phase at tiny-agent sizes, graph (built once on
    the CPU) and eager: both waves finish, wave 2 computes only the
    suffixes past the cached system prompt, the tokens of the two runs
    are equal, and both profiles run (device rows faked)."""
    from repro_torch import models
    from repro_torch.configs import get_config

    monkeypatch.setattr(smoke, "SERVE_LENS", [20, 33, 47, 5, 60, 12, 40, 28])
    monkeypatch.setattr(smoke, "MIXED_SCHED", dict(
        max_slots=8, num_pages=300, page_size=16, max_context=640,
        mixed=True, prefill_chunk=64, max_batch_tokens=72))
    monkeypatch.setattr(smoke, "SYSTEM_PROMPT", 48)
    monkeypatch.setattr(smoke, "PROFILE_LEN", 64)
    # the card profiles agent-7b's eager mixed steps no more; the
    # rehearsal keeps that path covered
    monkeypatch.setattr(smoke, "EAGER_PROFILES", ("serve mixed",))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "device_rows", lambda prof: [
        (400.0, 8, "void paged_split_kernel<__nv_bfloat16, 128, 4>(...)"),
        (3400.0, 40, "gemm")])
    cfg = get_config("tiny-agent").replace(dtype="float32", use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    launches = smoke.phase_serve_mixed(torch.device("cpu"), cfg, params,
                                       "serve mixed", max_new=8)
    assert set(launches.values()) == {0}           # CPU: plain versions
    out = capsys.readouterr().out
    assert out.count("prefill tokens computed 1709 of 2045 uncached "
                     "(wave 2: 1464 of 1800)") == 2
    assert "captures {'mixed': 1, 'decode': 1}" in out
    for how in ("graph", "eager"):
        assert f"mixed step ({how}): device busy 0.95 ms" in out
        assert f"decode step ({how}): device busy 0.95 ms" in out
    assert "greedy tokens equal (128 tokens)" in out


def test_control_parity_phase_runs_on_cpu(smoke, small, monkeypatch, capsys):
    """The control parity phase at tiny-agent sizes: pin, host and
    migrate, each with traffic beside the parked request, give the
    unsuspended run's tokens, paged (serialized and mixed) and ring."""
    monkeypatch.setattr(smoke, "CONTROL_TRAFFIC", 33)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    smoke.phase_control_parity(torch.device("cpu"), *small)
    out = capsys.readouterr().out
    assert out.count("tokens equal the unsuspended run's") == 9
    for what in ("paged:", "paged mixed:", "ring:"):
        assert out.count(f"f32, {what} ") == 3
    assert out.count("pos held at 73") == 3


def test_serve_control_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """The serve control phase at tiny-agent sizes, graph (built once on
    the CPU), eager and unsuspended: every request finishes, the
    controller sets and resets both knobs, request 3 lands on llm-1, and
    the resumed requests keep the unsuspended run's tokens."""
    from repro_torch import models
    from repro_torch.configs import get_config

    monkeypatch.setattr(smoke, "CONTROL_LENS", [
        20, 33, 47, 5, 60, 12, 40, 28, 9, 51, 17, 38, 22, 44, 30, 14])
    monkeypatch.setattr(smoke, "CONTROL_SCHED", dict(
        max_slots=8, num_pages=300, page_size=16, max_context=640,
        mixed=True, prefill_chunk=64, max_batch_tokens=72,
        host_capacity_pages=64))
    for name in ("reset_peak_memory_stats", "max_memory_allocated",
                 "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "card", lambda: "a CPU")
    cfg = get_config("tiny-agent").replace(dtype="float32", use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    launches = smoke.phase_serve_control(torch.device("cpu"), cfg, params)
    assert set(launches.values()) == {0}           # CPU: plain versions
    out = capsys.readouterr().out
    for how in ("graph", "eager", "unsuspended"):
        assert f"{how}, a CPU: 16 requests" in out
    assert out.count("captures {'llm-0': {'mixed': 1, 'decode': 1}, "
                     "'llm-1': {'decode': 1}}") == 2
    for i in range(4):
        assert f"request {i} ({('pin', 'pin', 'host', 'migrate')[i]}): " \
            "64 of 64 tokens equal the unsuspended run's" in out
    assert out.count("request 3 host tier migrate") == 2
    assert out.count("pinned at pos") == 4
    assert "greedy tokens equal (1024 tokens)" in out


# ---------------------------------------------------------------------------
# The phases of every architecture (xLSTM, the VLM, the encoder-decoder
# and the four other dense configs), rehearsed at smoke sizes
# ---------------------------------------------------------------------------

def test_expected_launches_of_xlstm(smoke):
    """An xLSTM ring engine launches the SSM scan once per mLSTM layer
    per prefill and no attention kernel; without the flag nothing.  At
    full width: 21 mLSTM layers of 24."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config, get_smoke

    cfg = get_smoke("xlstm-350m").replace(use_pallas=True)
    assert smoke.kind_layers(cfg, ("mlstm",)) == 4 and cfg.n_layers == 6
    eng = SimpleNamespace(cfg=cfg, device=torch.device("cuda"),
                          cache_layout="ring")
    assert smoke.expected_launches(eng, 3, 7) == {
        "paged_decode_attention": 0, "paged_flash_attention": 0,
        "flash_attention": 0, "decode_attention": 0, "ssm_scan": 4 * 3,
        "grouped_matmul": 0}
    eng.cfg = cfg.replace(use_pallas=False)
    assert set(smoke.expected_launches(eng, 3, 7).values()) == {0}
    full = get_config("xlstm-350m")
    assert smoke.kind_layers(full, ("mlstm",)) == 21
    assert smoke.kind_layers(full, ("slstm",)) == 3


@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_expected_launches_of_gemma3(smoke, layout):
    """gemma3-27b in full: 62 attention layers (52 local, 10 global),
    each launching the layout's kernels."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config

    cfg = get_config("gemma3-27b").replace(use_pallas=True)
    assert smoke.kind_layers(cfg, ("attn",)) == 62
    eng = SimpleNamespace(cfg=cfg, device=torch.device("cuda"),
                          cache_layout=layout)
    want = smoke.expected_launches(eng, 8, 63)
    if layout == "paged":
        assert want["paged_decode_attention"] == 62 * 63
    else:
        assert (want["flash_attention"], want["decode_attention"]) == \
            (62 * 8, 62 * 63)
    assert smoke.GEMMA_SCHED["num_pages"] == 128
    assert smoke.config_heads("gemma3-27b") == (16, 2, 128)


def test_new_paths_phase_on_cpu(smoke, monkeypatch, capsys):
    """phase_new_paths at short contexts and small heads on the CPU, where
    every wrapper takes its plain version: each check runs and agrees;
    the mLSTM layer is xlstm-350m's own, over 40 tokens."""
    monkeypatch.setattr(smoke, "CTX", [300, 257, 129, 100, 17, 0, 200, 200])
    monkeypatch.setattr(smoke, "SHARED_TOKENS", 128)
    monkeypatch.setattr(smoke, "ENC_FRAMES", 40)
    heads = {"gemma3-27b": (2, 2, 16), "h2o-danube-3-4b": (2, 4, 24),
             "llama3-405b": (1, 16, 16), "command-r-plus-104b": (1, 12, 16),
             "qwen2-vl-2b": (2, 6, 16), "seamless-m4t-large-v2": (4, 1, 16)}
    monkeypatch.setattr(smoke, "config_heads", heads.__getitem__)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters: (fn(), 1.0)[1])
    smoke.phase_new_paths(torch.device("cpu"))
    out = capsys.readouterr().out
    for name in smoke.SLICE_DENSE:
        assert out.count(f" {name} Hkv=") == 2 * 2 * 2   # dtypes, kernels
    assert out.count("non-causal") == 0
    assert out.count("causal=False") == 2 * 2
    assert out.count("cross attention of a seamless decode step") == 2
    assert out.count("inside an xlstm-350m mLSTM layer: T=40 H=4 dk=512 "
                     "dv=513") == 2
    assert out.count("max |kernel - plain| 0.000e+00") == out.count(
        "max |kernel - plain|")
    # G 6's chunks timed (faked here) at both contexts in both kernels,
    # and the planner restored
    assert out.count("chunks of 2/3/4/5 heads: 1.0000 / 1.0000 / 1.0000 / "
                     "1.0000 ms (group_chunk takes 3)") == 4
    from repro_torch.kernels import attention_shapes
    for fn in (smoke.paged_decode_attention, smoke.decode_attention):
        assert sys.modules[fn.__module__].group_chunk is \
            attention_shapes.group_chunk


def test_config_heads_of_the_slice(smoke):
    assert [smoke.config_heads(n) for n in smoke.SLICE_DENSE] == [
        (16, 2, 128), (8, 4, 120), (8, 16, 128), (8, 12, 128), (2, 6, 128)]
    assert smoke.config_heads("seamless-m4t-large-v2") == (16, 1, 64)


@pytest.mark.parametrize("name", ["gemma3-27b", "h2o-danube-3-4b",
                                  "llama3-405b", "command-r-plus-104b",
                                  "qwen2-vl-2b", "xlstm-350m"])
def test_width_parity_phases_run_on_cpu(smoke, monkeypatch, capsys, name):
    """The width parity phase of each new architecture at its smoke size
    on the CPU, with the phase's own cut, windows and layouts: greedy
    tokens equal across layouts, kernels on and off, graph and eager."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "PARITY_LENS", [20, 45])
    monkeypatch.setattr(smoke, "PARITY_SCHED", dict(
        max_slots=2, num_pages=24, page_size=16, max_context=64))
    _, cut, windows, layouts = next(w for w in smoke.WIDTH_PARITY
                                    if w[0] == name)
    windows = [(24, 8) if w == smoke.PARITY_SWA else (w[0], 8)
               for w in windows]
    cfg = get_smoke(name).replace(dtype="float32", **cut)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    smoke.phase_parity(torch.device("cpu"), cfg, params, layouts,
                       f"{name} smoke", windows, eager=True)
    out = capsys.readouterr().out
    how = ("paged and ring, with and without their kernels"
           if name != "xlstm-350m" else "ring, with and without its kernels")
    assert out.count(f"greedy tokens equal across {how}, graph and "
                     f"eager") == 1


@pytest.mark.parametrize("label", ["Gemma 3 12B's shape",
                                   "Llama 3.2 3B's shape"])
def test_wide_width_parity_runs_on_cpu(smoke, monkeypatch, capsys, label):
    """Phase 20's entries at the shapes the reference pads, on their
    configs' smokes with the head shape kept (dh 256 with the Gemma cut's
    local and global layer; G 3): greedy tokens equal across both
    layouts, kernels on and off, graph and eager."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "PARITY_LENS", [20, 45])
    monkeypatch.setattr(smoke, "PARITY_SCHED", dict(
        max_slots=2, num_pages=24, page_size=16, max_context=64))
    name, cut, windows, layouts, got = next(
        w for w in smoke.WIDTH_PARITY if w[4:] == (label,))
    heads = {"d_head": cut["d_head"],
             "n_kv_heads": 2, "n_heads": 2 * cut["n_heads"] // cut[
                 "n_kv_heads"]}
    rest = {k: v for k, v in cut.items()
            if k not in ("d_model", "n_heads", "n_kv_heads", "d_head",
                         "d_ff")}
    windows = [(24, 8) if w == smoke.PARITY_SWA else (w[0], 8)
               for w in windows]
    cfg = get_smoke(name).replace(dtype="float32", **heads, **rest)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    smoke.phase_parity(torch.device("cpu"), cfg, params, layouts,
                       f"{got} smoke", windows, eager=True)
    out = capsys.readouterr().out
    assert out.count("greedy tokens equal across paged and ring, with and "
                     "without their kernels, graph and eager") == 1


def test_wide_heads_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """Phase 39 at the smokes of its configs with the head shapes kept
    (dh 256; G 3; dh 512 at G 2; the xLSTM smoke's mLSTM past dk 512)
    on the CPU: paged, ring and mixed serving (xLSTM on the ring) with
    the eager runs' kernel calls held (plain against plain here), then
    the train step with every leaf moved."""
    from repro_torch.configs import get_smoke

    dense = ("paged", "ring", "mixed")
    monkeypatch.setattr(smoke, "WIDE_MODELS", [
        ("Gemma 3 12B's shape", "gemma3-27b",
         {"d_head": 256, "local_global_ratio": 1}, 2, dense, (2, 1, 32)),
        ("Llama 3.2 3B's shape", "llama3-405b",
         {"n_heads": 6, "n_kv_heads": 2}, 2, dense, (2, 1, 32)),
        ("agent-7b at d_head 512", "tiny-agent",
         {"d_head": 512, "n_heads": 4, "n_kv_heads": 2}, 2, dense,
         (2, 1, 32)),
        ("xLSTM 1.3B's width", "xlstm-350m",
         {"d_model": 520, "mlstm_ratio": 1}, 2,
         ("ring",), (2, 1, 32))])
    monkeypatch.setattr(smoke, "get_config",
                        lambda name: get_smoke(name).replace(
                            dtype="float32"))
    monkeypatch.setattr(smoke, "SERVE_LENS", [20, 33, 47, 5, 60, 12, 40, 28])
    monkeypatch.setattr(smoke, "SERVE_SCHED", dict(
        max_slots=8, num_pages=80, page_size=16, max_context=96))
    monkeypatch.setattr(smoke, "MIXED_SCHED", dict(
        max_slots=8, num_pages=300, page_size=16, max_context=320,
        mixed=True, prefill_chunk=64, max_batch_tokens=72))
    monkeypatch.setattr(smoke, "SYSTEM_PROMPT", 48)
    monkeypatch.setattr(smoke, "PROFILE_LEN", 64)
    monkeypatch.setattr(smoke, "WIDE_NEW", 6)
    monkeypatch.setattr(smoke, "TRAIN_FULL_STEPS", 1)
    for name in ("reset_peak_memory_stats", "max_memory_allocated",
                 "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "device_rows", lambda prof: [
        (400.0, 8, "void paged_split_kernel<float, 256, 2, false>(...)"),
        (3400.0, 40, "gemm")])
    used = smoke.phase_wide(torch.device("cpu"))
    assert {v for runs in used.values() for counts in runs.values()
            for v in counts.values()} == {0}       # CPU: plain versions
    assert set(used["xLSTM 1.3B's width"]) == {"ring", "train"}
    out = capsys.readouterr().out
    for label, name, _, _, layouts, _ in smoke.WIDE_MODELS:
        for how in layouts:
            assert f"[wide heads {label} {how}] eager run: every kernel " \
                "call held to its plain version" in out
        assert f"[wide heads {label}] train: 0 flash forward and 0 " \
            "backward calls, 0 ssm_scan forward and 0 backward calls " \
            "held" in out
    # the xLSTM smoke at d_model 520: an mLSTM of dk 520, dv 521, each
    # prefill's scan held (one mLSTM and one sLSTM layer)
    assert "'ssm_scan': 8" in out
    assert out.count("greedy tokens equal") == 10
    assert out.count("leaves moved") == 4


def test_xlstm_serve_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """The serve xlstm phase at xlstm-smoke sizes, graph (built once on
    the CPU) and eager, with its prefill profile (device rows faked, the
    sLSTM layers' events too): every request finishes, the tokens of the
    two runs are equal, and the scan's and sLSTM's shares are printed."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "SERVE_LENS", [20, 33, 47, 5, 60, 12, 40, 28])
    monkeypatch.setattr(smoke, "SERVE_SCHED", dict(
        max_slots=8, num_pages=300, page_size=16, max_context=640))
    monkeypatch.setattr(smoke, "PROFILE_LEN", 64)
    for name in ("reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "device_rows", lambda prof: [
        (300.0, 12, "void ssm_chunk_output_kernel<float>(...)"),
        (2700.0, 40, "gemm")])

    class Event:
        def __init__(self, **kw):
            self.t = 0.0

        def record(self):
            self.t = len(calls) * 2.5
            calls.append(self)

        def elapsed_time(self, end):
            return end.t - self.t
    calls = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    cfg = get_smoke("xlstm-350m").replace(dtype="float32", use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    launches = smoke.phase_serve(torch.device("cpu"), cfg, params, "ring",
                                 "serve xlstm", max_new=8,
                                 prefill_profile=True)
    assert set(launches.values()) == {0}           # CPU: plain versions
    out = capsys.readouterr().out
    assert "greedy tokens equal (64 tokens)" in out
    assert "prefill's ssm_scan kernels (chunk states, state pass, chunk " \
        "outputs): 0.300 ms in 12 launches (10.0% of the device time" in out
    # two sLSTM layers in the smoke model, each 2.5 ms between its events
    assert "prefill's sLSTM layers (a token loop of plain PyTorch ops, no " \
        "kernel of their own): 5.00 ms between events in 2 layers" in out


def test_vision_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """The model-level patch path of qwen2-vl at its smoke size: patch
    embeddings at (t, h, w) positions and text after them, kernels on and
    off: equal greedy tokens at 2 layers in f32, every kernel call held
    to its plain version at the full depth."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "VISION_GRID", (4, 3))
    monkeypatch.setattr(smoke, "VISION_TEXT", 9)
    cfg = get_smoke("qwen2-vl-2b").replace(use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    smoke.phase_vision(torch.device("cpu"), cfg, params)
    out = capsys.readouterr().out
    assert "12 patch embeddings at 3-axis positions + 9 text tokens" in out
    assert "f32: greedy tokens equal, kernels on vs off (34 tokens)" in out
    # 2 layers x (a prefill and 16 decode steps)
    assert "({'flash_attention': 2, 'decode_attention': 32}): max " \
        "|kernel - plain| 0.000e+00" in out


def test_encdec_phase_runs_on_cpu(smoke, monkeypatch, capsys):
    """The model-level encoder-decoder phase at seamless's smoke size:
    frames through the encoder, a prefill and decode steps, kernels on
    against off: equal tokens in f32 at 1 + 1 layers, every kernel call
    (the encoder's too) held to its plain version at full depth."""
    from repro_torch import models
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "ENC_FRAMES", 23)
    monkeypatch.setattr(smoke, "ENC_BATCH", 2)
    monkeypatch.setattr(smoke, "ENC_PROMPT", 5)
    monkeypatch.setattr(smoke, "ENC_STEPS", 6)
    cfg = get_smoke("seamless-m4t-large-v2").replace(use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    launched = smoke.phase_encdec(torch.device("cpu"), cfg, params)
    assert set(launched.values()) == {0}
    out = capsys.readouterr().out
    assert "1 + 1 layers, 2 x 23 frames, 5-token prompts, 6 decode steps, " \
        "f32: greedy tokens equal, kernels on vs off (14 tokens)" in out
    # flash: 2 encoder layers, 2 decoder layers' self and cross prefill;
    # decode: 2 layers' self and cross attention at 6 steps
    assert "({'flash_attention': 6, 'decode_attention': 24}): max " \
        "|kernel - plain| 0.000e+00" in out


def test_kernelwise_restores_the_wrappers(smoke):
    """kernelwise puts the model's kernel wrappers back on exit, an
    error inside included."""
    from repro_torch.models import attention

    real = (attention.flash_attention, attention.decode_attention)
    with pytest.raises(RuntimeError):
        with smoke.kernelwise() as kw:
            assert attention.flash_attention is not real[0]
            raise RuntimeError
    assert (attention.flash_attention, attention.decode_attention) == real
    assert kw.max_err() == 0.0


def test_cut_depth_takes_the_first_layers(smoke):
    from repro_torch import models
    from repro_torch.configs import get_smoke

    cfg = get_smoke("seamless-m4t-large-v2")
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    small = smoke.cut_depth(params, 1, torch.float32)
    w = params["decoder"][0]["e0"]["mlp"]["w_in"]
    got = small["decoder"][0]["e0"]["mlp"]["w_in"]
    assert tuple(got.shape) == (1,) + tuple(w.shape[1:])
    assert got.dtype == torch.float32 and torch.equal(got[0], w[0].float())
    assert small["encoder"][0]["e0"]["attn"]["wq"].shape[0] == 1
    assert small["embed"]["table"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The agent planes' phases (calibrate, serve disagg, the sim on the fits),
# rehearsed at tiny-agent sizes
# ---------------------------------------------------------------------------

def test_calibrate_phase_runs_on_cpu(smoke, monkeypatch, capsys, tmp_path):
    """The calibrate phase at tiny-agent width on the CPU (the plain
    kernel versions, backend "cpu"): every grid point measured, the fit
    saved as CALIB_tiny-agent.json and read back through costmodel_for;
    the port's calibration directory is not the reference's."""
    import repro.sim.costmodel as reference
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.sim import calibration, costmodel

    assert costmodel.DEFAULT_CALIB_DIR != reference.DEFAULT_CALIB_DIR
    monkeypatch.setattr(smoke, "CALIB_PREFILL_LENS", (16, 32, 64, 128))
    monkeypatch.setattr(smoke, "CALIB_DECODE_GRID",
                        ((1, 32), (1, 64), (2, 32), (4, 64), (8, 128)))
    cfg = get_config("tiny-agent").replace(dtype="float32", use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    calib = smoke.phase_calibrate(torch.device("cpu"), cfg, params, tmp_path)
    out = capsys.readouterr().out
    assert calib.backend == "cpu" and calib.tolerance == 0.75
    assert [(p.kind, p.batch, p.context) for p in calib.points] == [
        ("prefill", 1, n) for n in (16, 32, 64, 128)] + [
        ("decode", b, c) for b, c in smoke.CALIB_DECODE_GRID]
    assert all(p.measured_s > 0 for p in calib.points)
    assert calibration.load_calibration(
        tmp_path / "CALIB_tiny-agent.json") == calib
    assert out.count("relative error") == 9
    assert "costmodel_for read the fit back" in out
    assert "fit on a CPU, backend cpu" in out and "band 0.75" in out


def test_sim_phase_runs_on_the_fits(smoke, monkeypatch, capsys, tmp_path):
    """The sim phase on fits saved for the workflow's two tiers: both
    example pipelines finish, every sim engine carries its model's
    fitted scales, and a missing fit fails the phase."""
    from repro_torch.sim.calibration import Calibration, save_calibration
    from repro_torch.sim.clock import EventLoop

    orig = EventLoop.run_until
    monkeypatch.setattr(EventLoop, "run_until",
                        lambda self, t_end=float("inf"), max_events=10**7:
                        orig(self, min(t_end, 8.0), max_events))
    for i, name in enumerate(smoke.SIM_MODELS):
        save_calibration(Calibration(name, 1, "cpu", 1.5 + i, 2.7, 1e-3, 0.75,
                                     0.1, True), tmp_path / f"CALIB_{name}.json")
    smoke.phase_sim(tmp_path, "a CPU")
    out = capsys.readouterr().out
    assert "quickstart, simulated at the costs fitted on a CPU" in out
    assert "workflow, simulated at the costs fitted on a CPU: 24 tasks " \
        "done" in out
    assert "(agent-1b, agent-7b)" in out
    (tmp_path / "CALIB_agent-1b.json").unlink()
    with pytest.raises(AssertionError, match="not priced by a fit"):
        smoke.phase_sim(tmp_path, "a CPU")


def test_serve_disagg_phase_runs_on_cpu(smoke, monkeypatch, capsys,
                                        tmp_path):
    """The serve disagg phase at tiny-agent sizes: the 8 requests finish
    through a prefill-role and a decode-role engine with the unified
    run's tokens, in 8 handoffs through host memory."""
    from repro_torch import models
    from repro_torch.configs import get_config

    monkeypatch.setattr(smoke, "SERVE_LENS", [20, 33, 47, 5, 60, 12, 40, 28])
    monkeypatch.setattr(smoke, "SERVE_SCHED", dict(
        max_slots=8, num_pages=64, page_size=16, max_context=128))
    monkeypatch.setattr(smoke, "CALIB_DIR", tmp_path)
    monkeypatch.setattr(smoke, "card", lambda: "a CPU")
    cfg = get_config("tiny-agent").replace(dtype="float32", use_pallas=True)
    params = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    launches = smoke.phase_serve_disagg(torch.device("cpu"), cfg, params)
    assert set(launches.values()) == {0}           # CPU: plain versions
    out = capsys.readouterr().out
    assert "greedy tokens equal the unified paged run's (512 tokens)" in out
    assert "8 handoffs through pinned host memory" in out
    assert out.count("extract to pinned host memory") == 8


# ---------------------------------------------------------------------------
# The training phases
# ---------------------------------------------------------------------------

def test_flash_backward_bound_and_cases(smoke):
    """The backward's bound counts 10 * dh operations per valid pair; the
    cases cover the issue's shapes (windows, G 12 and 16, dh 120, a
    ragged S, non-causal, rows with no valid key)."""
    q = torch.zeros((1, 1024, 32, 128), dtype=torch.bfloat16)
    k = torch.zeros((1, 1024, 8, 128), dtype=torch.bfloat16)
    ms, by = smoke.bwd_bound(q, k, True, -1)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 10 * 128 * 32 * 1024 * 1025 / 2
                               / smoke.BF16_OPS_PER_S)
    heads = {c[0] for c in smoke.BWD_CASES}
    assert {(128, 8, 128), (96, 8, 128), (32, 8, 120)} <= heads
    assert any(not c[4] for c in smoke.BWD_CASES)
    assert any(c[2] > c[3] and c[5] > 0 for c in smoke.BWD_CASES)


def test_hold_flash_calls_on_recorded_cpu_calls(smoke, capsys):
    """record_flash keeps each call's inputs and outputs; held to the
    plain versions they agree (here the plain versions themselves)."""
    from repro_torch.kernels import flash_attention as fa_mod  # noqa: F401
    mod = sys.modules["repro_torch.kernels.flash_attention"]
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((1, 30, 4, 32), (1, 30, 2, 32), (1, 30, 2, 32)))
    dout = torch.randn(q.shape, generator=gen)

    def fake_fwd(q, k, v, causal, window, with_lse=False):
        out = mod.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        lse = mod.flash_attention_lse_plain(q, k, causal=causal,
                                            window=window)
        return (out, lse) if with_lse else out

    def fake_bwd(q, k, v, out, lse, dout, causal, window):
        return mod.flash_attention_backward_plain(q, k, v, dout,
                                                  causal=causal,
                                                  window=window)

    real = (mod._launch, mod._launch_backward)
    try:
        mod._launch, mod._launch_backward = fake_fwd, fake_bwd
        with smoke.record_flash(True) as fw, \
                smoke.record_flash(False, picks={1}) as bw:
            for _ in range(2):
                out, lse = mod._launch(q, k, v, True, 7, with_lse=True)
                mod._launch_backward(q, k, v, out, lse, dout, True, 7)
        assert (mod._launch, mod._launch_backward) == (fake_fwd, fake_bwd)
    finally:
        mod._launch, mod._launch_backward = real
    assert [c[0] for c in fw] == [0, 1] and [c[0] for c in bw] == [1]
    assert smoke.hold_flash_calls("rehearsal", fw, bw, torch.float32) == 0
    assert capsys.readouterr().out.count("(tolerance 2e-05)") == 3


def test_model_flops_of_agent_7b(smoke):
    """About 4.3e14 executed FLOP a step of B 2 x S 4096 under remat."""
    from repro_torch.configs import get_config

    mf, hf = smoke.model_flops(get_config("agent-7b"), 2, 4096)
    assert 2.9e14 < mf < 3.3e14 and 3.9e14 < hf < 4.5e14
    assert hf / mf == pytest.approx(4 / 3, rel=0.02)


def test_train_phases_run_on_cpu(smoke, monkeypatch, capsys, tmp_path):
    """The training phases at tiny-agent sizes on the CPU (plain
    versions, so no launch): parity, the full-depth steps with every
    leaf changed and a profiled step, microbatches, and the train_lm
    twin's restart (its 75 steps checkpoint at 50 and fail at 50)
    equal to the uninterrupted run."""
    for name, value in (("TRAIN_PARITY_MODEL", "tiny-agent"),
                        ("TRAIN_PARITY_SEQ", 48), ("TRAIN_MODEL", "tiny-agent"),
                        ("TRAIN_1B_MODEL", "tiny-agent"), ("TRAIN_SEQ", 32),
                        ("TRAIN_STEPS", 2), ("TRAIN_LM_MODEL", "tiny-agent"),
                        ("TRAIN_LM_STEPS", 75), ("TRAIN_LM_BATCH", 4),
                        ("TRAIN_LM_SEQ", 32), ("ROOT", tmp_path)):
        monkeypatch.setattr(smoke, name, value)
    dev = torch.device("cpu")
    smoke.phase_train_parity(dev)
    used = smoke.phase_train(dev)
    smoke.phase_train_1b(dev)
    smoke.phase_train_lm(dev)
    assert set(used.values()) == {0}
    out = capsys.readouterr().out
    assert out.count("after one step the parameters of the f32- and int8-"
                     "moment runs are equal bit for bit") == 2
    assert "every one of 12 parameter leaves changed (a strided sample" in out
    assert "[profile] train: train step: " in out
    assert smoke.kernel_class("nvjet_tst_192x192") == "matmul"
    assert "2 microbatches of B 1 x S 32" in out
    assert "losses equal the uninterrupted run's" in out


def test_init_train_rescales_attention_to_true_fan_in(smoke, monkeypatch):
    """init_train: the reference's seeded weights with wq, wk and wv at
    1/sqrt(d_model) and wo at 1/sqrt(H * dh) (``attention.
    rescale_to_true_fan_in``); nothing else moves."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models import params as prm

    monkeypatch.setattr(smoke, "card", lambda: "a CPU")
    cfg = get_config("agent-7b").replace(n_layers=2, d_model=512, n_heads=8,
                                         n_kv_heads=2, d_ff=64, vocab=64,
                                         dtype="float32")
    got = smoke.init_train(cfg, torch.device("cpu"), "rehearsal")
    ref = models.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    attn = got["decoder"][0]["e0"]["attn"]
    # d_head stays 128 under replace: wo's fan-in is 8 heads x 128
    for name, fan in (("wq", 512), ("wk", 512), ("wv", 512), ("wo", 1024)):
        assert attn[name].std().item() == pytest.approx(fan ** -0.5, rel=0.05)
    same = [torch.equal(a, b) for a, b in zip(prm.flatten(got)[0],
                                              prm.flatten(ref)[0])]
    assert same.count(False) == 4


# ---------------------------------------------------------------------------
# The other families' training phases
# ---------------------------------------------------------------------------

def test_backward_kernel_phase_on_cpu(smoke, monkeypatch, capsys):
    """Phase 33's helpers at small shapes, the kernels' places taken by
    their plain versions (the CPU has no kernel): the grouped_matmul
    backward's inputs hold counts of 0, C and C / 3 with zeros past each
    count, the checks pass and find two runs equal, the bmm yardstick
    computes the same dx and dw, and the bounds count what they claim."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul_backward_plain)
    from repro_torch.kernels.ssm_scan import ssm_scan_backward_plain

    monkeypatch.setattr(smoke, "grouped_matmul_backward",
                        grouped_matmul_backward_plain)

    def part_plain(x, w, counts, dout, need_dx, need_dw):
        grads = grouped_matmul_backward_plain(x, w, counts, dout)
        return tuple(g if n else None for g, n in zip(grads,
                                                      (need_dx, need_dw)))
    monkeypatch.setattr(smoke, "gm_launch_backward", part_plain)
    monkeypatch.setattr(smoke, "ssm_scan_backward", ssm_scan_backward_plain)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, iters, warmup=3:
                        (fn(), 1.0)[1])
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    arctic = get_config("arctic-480b")
    x, w, counts, dout = smoke.gm_bwd_inputs(torch.float32, 10, 24, 16, 200,
                                             2, arctic, gen, dev)
    c = smoke.capacity(200, arctic)
    assert tuple(x.shape) == (10, c, 24) and tuple(dout.shape) == (10, c, 16)
    assert counts[:3].tolist() == [0, c, c // 3]
    dead = torch.arange(c)[None, :] >= counts[:, None]
    assert not x[dead].any() and not dout[dead].any()
    assert smoke.check_gm_backward(x, w, counts, dout, "rehearsal", 4) == 0
    ms, plain_ms, lib_ms, bound_ms, by = smoke.time_gm_backward(
        x, w, counts, dout, "rehearsal")
    rows, live = int(counts.sum()), int((counts > 0).sum())
    nbytes = (live * 24 * 16 + rows * 40 + 10 * c * 24 + 10 * 24 * 16) * 4 \
        + 40
    t_bytes = nbytes / smoke.HBM_BYTES_PER_S
    t_ops = 4 * rows * 24 * 16 / smoke.F32_OPS_PER_S
    assert bound_ms == pytest.approx(1e3 * max(t_bytes, t_ops))
    case = (1, 70, 3, 8, 12, 32, True, 0.3, 0.5, True)
    assert smoke.check_scan_backward(torch.float32, case, gen, dev) == 0
    q, k, v, la, h0, dy, dh_t = smoke.scan_bwd_args(torch.float32, case,
                                                    gen, dev)
    assert q.stride(2) == 0 and tuple(dh_t.shape) == (1, 3, 8, 12)
    states = torch.zeros((1, 3, 3, 8, 12))
    ms, by = smoke.scan_bwd_bound(q, k, v, states)
    # q and k once (one row for the heads); v, dy, dv; log_a and dlog_a;
    # the states; dq and dk at full shape
    nbytes = (2 * 70 * 8 + 3 * 70 * 3 * 12 + 2 * 70 * 3 + 3 * 3 * 8 * 12
              + 2 * 70 * 3 * 8) * 4
    ops = 70 * 3 * (2 * 70 * (3 * 8 + 2 * 12) + 8 * 8 * 12)
    assert ms == pytest.approx(1e3 * max(nbytes / smoke.HBM_BYTES_PER_S,
                                         ops / smoke.F32_OPS_PER_S))
    assert by == "operations"
    for part in ("dx", "dw"):
        got = smoke.gm_backward_part(x, w, counts, dout, part)
        assert (got[0] is None) == (part == "dw")
        assert (got[1] is None) == (part == "dx")
    ms_dx, by_dx = smoke.gm_bwd_bound(x, w, counts, "dx")
    ms_dw, by_dw = smoke.gm_bwd_bound(x, w, counts, "dw")
    dx_bytes = (live * 24 * 16 + rows * 16 + 10 * c * 24) * 4 + 40
    dw_bytes = (rows * 40 + 10 * 24 * 16) * 4 + 40
    assert ms_dx == pytest.approx(1e3 * max(
        dx_bytes / smoke.HBM_BYTES_PER_S, t_ops / 2))
    assert ms_dw == pytest.approx(1e3 * max(
        dw_bytes / smoke.HBM_BYTES_PER_S, t_ops / 2))
    out = capsys.readouterr().out
    assert out.count("two runs equal bit for bit") == 2
    assert "two bmm over every expert" in out
    assert "dX alone: kernel" in out and "dW alone: kernel" in out


def test_train_launches_of_each_family(smoke):
    """The launches of one forward-and-backward pass under remat: a
    second forward of each kernel per layer, one backward."""
    from repro_torch.configs import get_config

    def nonzero(cfg):
        return {k: v for k, v in smoke.train_launches(cfg).items() if v}
    assert nonzero(get_config("arctic-480b").replace(n_layers=1)) == {
        "flash_attention": 2, "flash_attention_backward": 1,
        "grouped_matmul": 6, "grouped_matmul_backward": 3}
    assert nonzero(get_config("hymba-1.5b")) == {
        "flash_attention": 64, "flash_attention_backward": 32,
        "ssm_scan": 64, "ssm_scan_backward": 32}
    assert nonzero(get_config("xlstm-350m")) == {
        "ssm_scan": 42, "ssm_scan_backward": 21}
    assert nonzero(get_config("qwen2-vl-2b")) == {
        "flash_attention": 56, "flash_attention_backward": 28}
    # 24 encoder layers, 24 decoder layers of self and cross attention
    assert nonzero(get_config("seamless-m4t-large-v2")) == {
        "flash_attention": 144, "flash_attention_backward": 72}
    kimi = get_config("kimi-k2-1t-a32b").replace(n_layers=2, remat=False)
    assert nonzero(kimi) == {"flash_attention": 2,
                             "flash_attention_backward": 2,
                             "grouped_matmul": 3,
                             "grouped_matmul_backward": 3}
    assert smoke.train_launches(kimi, 3)["grouped_matmul"] == 9


def test_hold_training_calls_on_recorded_cpu_calls(smoke, capsys):
    """hold_training_calls holds each recorded grouped_matmul and
    ssm_scan call, forward and backward, on its own inputs (here the
    plain versions' outputs, so every error is 0); record_calls keeps
    the calls made inside the block and restores the function."""
    import importlib

    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul_backward_plain, grouped_matmul_plain)
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward_plain,
                                              ssm_scan_plain)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 8, 16), generator=gen)
    w = torch.randn((4, 16, 12), generator=gen)
    counts = torch.tensor([8, 0, 3, 5], dtype=torch.int32)
    dout = torch.randn((4, 8, 12), generator=gen)
    q, k = (torch.randn((1, 20, 2, 4), generator=gen) for _ in range(2))
    v = torch.randn((1, 20, 2, 6), generator=gen)
    la = -torch.rand((1, 20, 2), generator=gen)
    h0 = torch.zeros((1, 2, 4, 6))
    dy = torch.randn((1, 20, 2, 6), generator=gen)
    states = torch.zeros((1, 2, 3, 4, 6))            # chunk 8: 3 chunks
    mod = importlib.import_module("repro_torch.kernels.grouped_matmul")
    real = mod._launch
    try:
        mod._launch = grouped_matmul_plain
        with smoke.record_calls(smoke.GM_MOD, "_launch") as calls:
            mod._launch(x, w, counts)
        assert mod._launch is grouped_matmul_plain
    finally:
        mod._launch = real
    recorded = {
        "gm_fwd": calls,
        "gm_bwd": [((x, w, counts, dout, True, True),
                    grouped_matmul_backward_plain(x, w, counts, dout))],
        "scan_fwd": [((q, k, v, la, h0, 8),
                      ssm_scan_plain(q, k, v, la, h0, chunk=8))],
        "scan_bwd": [((q, k, v, la, states, None, dy, None, 8),
                      ssm_scan_backward_plain(q, k, v, la, h0, dy,
                                              chunk=8))]}
    assert len(calls) == 1
    assert smoke.hold_training_calls("rehearsal", recorded,
                                     torch.float32) == 0
    out = capsys.readouterr().out
    assert out.count("rehearsal") == 4


def test_family_batch_carries_each_familys_inputs(smoke, monkeypatch):
    from repro_torch.configs import get_smoke

    monkeypatch.setattr(smoke, "VISION_GRID", (4, 3))
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cpu")
    vlm = smoke.family_batch(get_smoke("qwen2-vl-2b"), 2, 20, gen, dev)
    assert tuple(vlm["vision_embeds"].shape[:2]) == (2, 12)
    assert tuple(vlm["positions"].shape) == (2, 20, 3)
    assert vlm["positions"][0, 12].tolist() == [4, 4, 4]
    assert (vlm["labels"][:, :-1] == vlm["tokens"][:, 1:]).all()
    assert (vlm["labels"][:, -1] == -1).all()
    enc = smoke.family_batch(get_smoke("seamless-m4t-large-v2"), 2, 9, gen,
                             dev, frames=13)
    assert tuple(enc["frames"].shape[:2]) == (2, 13)
    assert set(smoke.family_batch(get_smoke("hymba-1.5b"), 1, 5, gen,
                                  dev)) == {"tokens", "labels"}


def test_family_train_phases_run_on_cpu(smoke, monkeypatch, capsys):
    """Phases 34-37 at the families' smoke configs on the CPU (plain
    versions, so no launch): parity kernels on and off, the MoE's
    gradient and step, hymba, xlstm, qwen2-vl and seamless trained with
    every leaf moved."""
    from repro_torch.configs import get_smoke

    for name, value in (("get_config", get_smoke), ("FAMILY_SEQ", 32),
                        ("VISION_GRID", (4, 3)), ("TRAIN_SEQ", 32),
                        ("MOE_TRAIN_EXPERTS", 4),
                        ("SSM_TRAIN", [("hymba-1.5b", 1, 32),
                                       ("xlstm-350m", 1, 16)]),
                        ("VLM_TRAIN", ("qwen2-vl-2b", 1, 32)),
                        ("ENCDEC_TRAIN", ("seamless-m4t-large-v2", 1, 16,
                                          20)),
                        ("TRAIN_FULL_STEPS", 1),
                        ("card", lambda: "a CPU")):
        monkeypatch.setattr(smoke, name, value)
    for name in ("reset_peak_memory_stats", "max_memory_allocated",
                 "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    dev = torch.device("cpu")
    smoke.phase_train_families(dev)
    moe = smoke.phase_train_moe(dev)
    ssm = smoke.phase_train_ssm(dev)
    smoke.phase_train_vlm_encdec(dev)
    assert set(moe.values()) == set(ssm.values()) == {0}
    out = capsys.readouterr().out
    assert out.count("make_train_step, f32 moments") == 6
    assert out.count("leaves moved") == 6 + 5
    assert "4 experts, bf16, remat, int8 moments" in out
    assert "(and 20 frames a row)" in out


def test_sharded_phase_runs_on_cpu(smoke, monkeypatch, tmp_path, capsys):
    """Phase 38 at tiny sizes with its ranks on the CPU: (a) world 1 over
    gloo, the mesh steps bit-equal to the mesh-less ones; (b) and (c) two
    spawned gloo ranks, TP and EP on (1, 2) and DP + FSDP on (2, 1), held
    to the unsharded model; (d) and (e) the same ranks serving over a
    sequence-sharded ring (the GQA fallback on (1, 2), a long shape on
    (2, 1)), both ranks holding keys, held to the unsharded model; (f)
    TP over ``model`` of the hymba, xlstm, qwen2-vl (patch embeddings)
    and seamless (frames) smokes on (1, 2), served and trained, held to
    the unsharded model; (b) and (f) sequence parallel, remat keeping
    half the whole-S bytes at the layer boundaries; (g) the seamless
    smoke under a long shape on (2, 1), its cross K/V cut along the
    encoder axis, held to the unsharded model; (h) (c)'s state saved and
    restored three ways bit for bit, a TP step from it held to the
    unsharded model, and a supervised TP run resumed after a failure
    bit-equal to an uninterrupted one."""
    monkeypatch.setattr(smoke, "SHARDED_FULL", "tiny-agent")
    monkeypatch.setattr(smoke, "SHARDED_PROMPT", 16)
    monkeypatch.setattr(smoke, "SHARDED_DECODE", 3)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "SHARDED_TP", ("tiny-agent", {}))
    monkeypatch.setattr(smoke, "SHARDED_EP", ("smoke:arctic-480b", {}))
    monkeypatch.setattr(smoke, "SHARDED_SERVE_PROMPT", 16)
    monkeypatch.setattr(smoke, "SHARDED_NEW", 4)
    monkeypatch.setattr(smoke, "SHARDED_TRAIN_SEQ", 32)
    monkeypatch.setattr(smoke, "SHARDED_DIR", tmp_path)
    monkeypatch.setattr(smoke, "SHARDED_GQA", ("tiny-agent",
                                               {"n_kv_heads": 1}))
    monkeypatch.setattr(smoke, "SHARDED_GQA_PROMPT", 136)
    monkeypatch.setattr(smoke, "SHARDED_LONG", ("tiny-agent", {}))
    monkeypatch.setattr(smoke, "SHARDED_LONG_RING", 192)
    monkeypatch.setattr(smoke, "SHARDED_LONG_PROMPT", 100)
    monkeypatch.setattr(smoke, "SHARDED_FAMILIES", [
        ("smoke:hymba-1.5b", {}), ("smoke:xlstm-350m", {}),
        ("smoke:qwen2-vl-2b", {}), ("smoke:seamless-m4t-large-v2", {})])
    monkeypatch.setattr(smoke, "VISION_GRID", (2, 3))
    monkeypatch.setattr(smoke, "SHARDED_PATCHES", 4)
    monkeypatch.setattr(smoke, "SHARDED_FRAMES", 12)
    monkeypatch.setattr(smoke, "SHARDED_CROSS",
                        ("smoke:seamless-m4t-large-v2", {}))
    monkeypatch.setattr(smoke, "SHARDED_SUP", ("tiny-agent", {}, 2, 16, 6, 2,
                                               4))
    seq = smoke.phase_sharded(torch.device("cpu"))
    assert seq == {}                     # the CPU launches no kernel
    out = capsys.readouterr().out
    assert "(a) world 1, gloo, mesh (1, 1), tiny-agent" in out
    assert "bit for bit" in out
    for what in ("(b) mesh (1, 2), TP, rank 0", "(b) mesh (1, 2), EP, rank 1",
                 "(c) mesh (2, 1), DP + FSDP, rank 1",
                 "(f) mesh (1, 2), TP of hymba-1.5b, rank 1: "
                 "hymba-1.5b width, 5 layer(s), f32",
                 "(f) mesh (1, 2), TP of xlstm-350m, rank 0",
                 "(f) mesh (1, 2), TP of qwen2-vl-2b, rank 1",
                 "(f) mesh (1, 2), TP of seamless-m4t-large-v2, rank "
                 "0: seamless-m4t-large-v2 width, 2 layer(s) + 2 encoder "
                 "layer(s)"):
        assert what in out
    # (b), (f) served on rank 0; (d), (e), (g) on rank 0
    assert out.count("greedy tokens equal the unsharded run's") == 4 + 4 + 1
    assert out.count("equal rank 0's; train step loss") == 2 + 4
    # (b), (c), (c') twice, (f), and (h)'s step from the restored state
    assert out.count("gradient shards within") == 2 * (3 + 2 + 4 + 1)
    # (c'): rank 1 holds no row of either microbatch, runs both, and
    # makes rank 0's collectives
    for key in ("of one row", "of one row, the MoE's global dispatch"):
        for r, rows in ((0, 1), (1, 0)):
            assert f"(c') mesh (2, 1), DP + FSDP, B 2 in 2 microbatches " \
                f"{key}, rank {r}: " in out
    assert out.count("0 row(s) of each microbatch: train step loss") == 2
    assert out.count("1 row(s) of each microbatch: train step loss") == 2
    assert out.count("collectives equal rank 0's in kind and group size") \
        == 4
    assert out.count("(c') arctic's width, rank 1 empty, rank 1: the train "
                     "step's") == 1
    for r in (0, 1):
        assert f"(h) checkpoints, rank {r}: (c)'s state (tiny-agent width, " \
            "2 layer(s), f32, int8 moments, 61 leaves), saved async" in out
        assert f"(h) supervised, rank {r}: TrainSupervisor over the TP " \
            "step, tiny-agent width, 2 layer(s), bf16, int8 moments, B 2 x " \
            "S 16, 6 steps, checkpoints every 2" in out
    assert out.count("every leaf bit-equal to (c)'s state gathered") == 2
    assert out.count("restarted at step 4): the losses by step") == 2
    assert "(d) mesh (1, 2), GQA fallback: the ring cut over model, " \
        "rank 1: tiny-agent width, 2 layers, 4 heads over 1 KV head(s), " \
        "f32, kernels on, 132 of the ring's 264 slots" in out
    assert "(e) mesh (2, 1), long: the ring cut over data, rank 0: " \
        "tiny-agent width, 2 layers, 4 heads over 2 KV head(s), weights " \
        "whole on each rank, f32, kernels on, 96 of the ring's 192 slots" \
        in out
    assert "two CPU processes over gloo" in out
    # (b) and (f) sequence parallel: remat kept half the whole-S figure;
    # (c) on (2, 1) all of it
    assert out.count("remat kept") == 2 * (2 + 1 + 4)
    assert out.count("1/2 of the whole-S figure") == 2 * (2 + 4)
    assert out.count("1/1 of the whole-S figure") == 2
    assert "remat kept 32768 B (0.033 MB) at the layer boundaries (inputs " \
        "[2, 16, 128]), 1/2 of the whole-S figure 65536 B" in out
    assert "max_memory_allocated over the train step not measured" in out
    # (g) the cross K/V cut along its 16 encoder positions over data
    assert "(g) mesh (2, 1), long: the ring and the cross K/V cut over " \
        "data, rank 1: seamless-m4t-large-v2 width, 2 layers + 2 encoder " \
        "layer(s), 4 heads over 4 KV head(s), weights whole on each rank, " \
        "f32, kernels on, 96 of the ring's 192 slots" in out
    assert out.count("the cross K/V 8 of the 16 encoder positions") == 2


def test_combine_phase_inputs_bound_and_held_errors(smoke):
    """phase_combine's inputs: the rank's full slot range all valid, the
    empty ranks and the row empty everywhere; the combine's byte bound;
    ``call_err`` on (out, lse) pairs, infinite where the empty rows
    disagree."""
    from repro_torch.kernels import (attention_combine_plain,
                                     decode_attention_plain)

    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    q, k, v, kpos, q_pos = smoke.lse_decode_case(torch.float32, gen, dev)
    b, slots, hkv, g, dh = smoke.LSE_DECODE
    assert tuple(q.shape) == (b, 1, hkv * g, dh)
    assert tuple(k.shape) == (b, slots, hkv, dh)
    assert bool(smoke.ring_valid((q, k, v, kpos, q_pos), -1).all())
    outs, lses = smoke.combine_case(torch.float32, gen, dev)
    r = smoke.COMBINE[0]
    assert (lses[r - smoke.COMBINE_EMPTY:, 0] == -1e30).all()
    assert (lses[:, 1] == -1e30).all() and (lses[0, 0] > -1e29).all()
    got = attention_combine_plain(outs, lses)
    assert not got[1].any() and torch.isfinite(got).all()
    ms, by = smoke.combine_bound(outs, lses)
    n = outs.numel() * 4 + lses.numel() * 4 + got.numel() * 4
    assert by == "bytes" and ms == pytest.approx(
        1e3 * n / smoke.HBM_BYTES_PER_S)
    pair = decode_attention_plain(q[:2, :, :8], k[:2, :64, :2],
                                  v[:2, :64, :2], kpos[:2, :64].contiguous(),
                                  q_pos[:2], with_lse=True)
    assert smoke.call_err(pair, pair).item() == 0.0
    shifted = (pair[0], pair[1].clone())
    shifted[1][0, 0] = -1e30
    assert smoke.call_err(shifted, pair).item() == float("inf")
    zeros = torch.zeros(3, 4)
    assert smoke.call_err(zeros, zeros).item() == 0.0


def test_smoke_cuts_undoes_each_cut(smoke, monkeypatch):
    """``tools/smoke_cuts.py``'s old runs: each constant a cut may set
    at its value before any cut, nothing else of the smoke changed, and
    the ``[time]`` lines read back as each phase's seconds."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import smoke_cuts

    monkeypatch.setattr(smoke, "EAGER_NEW", 8)
    monkeypatch.setattr(smoke, "SHARDED_NEW", 8)
    monkeypatch.setattr(smoke, "WIDE_MODELS", list(smoke.WIDE_MODELS))
    before = list(smoke.WIDE_MODELS)
    assert before[-1][1] == "xlstm-350m" and before[-1][5] == (8, 2, 512)
    smoke_cuts.undo_cuts(smoke)
    assert (smoke.EAGER_NEW, smoke.SHARDED_NEW) == (16, 16)
    assert smoke.WIDE_MODELS[:-1] == before[:-1]
    assert smoke.WIDE_MODELS[-1] == before[-1][:5] + ((8, 2, 1024),)
    assert smoke_cuts.phase_times(
        "[time] 2 build: 24.5 s\nx\n[time] 38 sharded: 129.3 s\n") == {
            "2 build": 24.5, "38 sharded": 129.3}
