"""Paged flash attention: the hand-written Hopper kernel, its plain
PyTorch version, and the wrapper the model calls.

Port-side: no Pallas kernel computes this.  The reference's
``self_attention_paged`` (``repro/models/attention.py``) sends every
call with more than one query row -- suffix prefill and the mixed step's
padded chunk -- to ``paged_view`` + ``attention_cached``, a gather of each
sequence's whole block table into a contiguous view and masked f32
scores over it.  This kernel computes that function over the pool in
place.  The CUDA source is ``csrc/paged_flash_attention.cu``, whose
bodies are the flash forward's (``csrc/flash_fwd.cuh``) with the keys
read through the table.

q (B, S, H, dh) at positions q_pos (B, S) int32 (-1: a pad row) attends
over the pools (num_pages + 1, page, Hkv, dh) through block_tables (B, P)
int32 (-1: unmapped): key ``j`` of row ``b`` is slot ``j % page`` of pool
page ``block_tables[b, j // page]``, valid when that entry is mapped,
``j <= q_pos`` and, with a window, ``j > q_pos - window``.  Query head
``h`` reads KV head ``h // (H // Hkv)``.  Scores and softmax are f32 with
``NEG_INF = -1e30``; the output takes ``q``'s dtype.  A row with no valid
key comes out as zeros from the kernel and as the uniform average (the
reference's all-masked softmax) from the plain version: compare live
rows.

Bound on the card: operations, ``4 * dh`` per valid (row, head, key),
against the tensor cores' bf16 rate (f32: the CUDA cores' 67 TFLOP/s).
bf16 with dh a multiple of 8 up to 256 and pages a multiple of 8 runs on
the TMA + ``wgmma`` body of ``flash_attention``, its K/V boxes at page
ids the producer warp reads from the table; f32, any other dh or
page, and dh past 256 on the CUDA-core and column-block bodies, rows
through the table.  Nothing is padded or copied: a dh that is not a
multiple of 8 is read in place.  Each item's key tiles follow from its
rows' positions on the device, so the launch takes no host value of the
data and a CUDA graph replays it for any chunk start and fill.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import work
from repro_torch.kernels.attention_shapes import DTYPES, check_attention_shape
from repro_torch.kernels.grad import refuse_grad

NEG_INF = -1e30


def paged_flash_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                q_pos: torch.Tensor, *,
                                window: int = -1) -> torch.Tensor:
    """Gather-then-attend, as the gather path computes it
    (``models/attention.py``'s ``paged_view`` + ``attention_cached``):
    each row's table gathered into (B, P * page) keys whose position is
    their index where the page is mapped and -1 where not, f32 scores
    masked by ``0 <= kpos <= q_pos`` (and the window), softmax, and P in
    the values' dtype against the values.  Returns (B, S, H, dh)."""
    b, s, h, dh = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    p_max = block_tables.shape[1]
    t = p_max * page
    ids = block_tables.long().clamp(min=0)
    k = k_pages[ids].reshape(b, t, hkv, dh)
    v = v_pages[ids].reshape(b, t, hkv, dh)
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)[None]
    mapped = torch.repeat_interleave(block_tables >= 0, page, dim=1)
    kpos = torch.where(mapped, kpos.expand(b, t), -1)
    qp = q_pos[:, :, None]
    mask = (kpos[:, None, :] <= qp) & (kpos[:, None, :] >= 0)
    if window > 0:
        mask &= kpos[:, None, :] > qp - window
    qg = q.reshape(b, s, hkv, h // hkv, dh)
    scores = torch.einsum("bqhgd,bthd->bhgqt", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, s, h, dh)


def _valid(block_tables: torch.Tensor, q_pos: torch.Tensor, page: int,
           window: int) -> torch.Tensor:
    """(B, S, P * page) bool: the valid (row, key) pairs."""
    kpos = torch.arange(block_tables.shape[1] * page, device=q_pos.device)
    mapped = torch.repeat_interleave(block_tables >= 0, page, dim=1)
    qp = q_pos.long()[:, :, None]
    valid = mapped[:, None, :] & (kpos <= qp)
    if window > 0:
        valid &= kpos > qp - window
    return valid


def live_rows(block_tables: torch.Tensor, q_pos: torch.Tensor, page: int,
              window: int = -1) -> torch.Tensor:
    """(B, S) bool: the query rows with at least one valid key, where the
    kernel and the plain version agree (the others: zeros and the uniform
    average)."""
    return _valid(block_tables, q_pos, page, window).any(-1)


def valid_counts(block_tables: torch.Tensor, q_pos: torch.Tensor, page: int,
                 window: int = -1) -> tuple[int, int]:
    """(valid (row, key) pairs, live keys) of a call on these inputs: the
    pairs the scores need, summed over the batch (times H in the
    operations), and the keys some row of their sequence attends, whose
    K/V the call must read.  Host ints, read from the tensors (a timing
    script's bound, never a step's path)."""
    valid = _valid(block_tables, q_pos, page, window)
    return int(valid.sum()), int(valid.any(1).sum())


def _check(q, k_pages, v_pages, block_tables, q_pos) -> None:
    if q.ndim != 4:
        raise ValueError(f"q must be (B, S, H, dh), got {tuple(q.shape)}")
    b, s, h, dh = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must be equal (N + 1, page, "
                         f"Hkv, dh), got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    if k_pages.shape[3] != dh or h % k_pages.shape[2]:
        raise ValueError(f"pool {tuple(k_pages.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or block_tables.shape[1] == 0:
        raise ValueError(f"block_tables must be (B, P) with B={b}, P >= 1")
    if q_pos.shape != (b, s):
        raise ValueError(f"q_pos must be ({b}, {s}), got "
                         f"{tuple(q_pos.shape)}")
    if block_tables.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError("block_tables and q_pos must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError("q, k_pages and v_pages must share a dtype")
    if s == 0:
        raise ValueError("empty query axis")
    devs = {x.device for x in (q, k_pages, v_pages, block_tables, q_pos)}
    if len(devs) != 1:
        raise ValueError(f"inputs span devices {sorted(map(str, devs))}")


def _launch(q, k_pages, v_pages, block_tables, q_pos,
            window: int) -> torch.Tensor:
    from repro_torch.kernels import build

    b, s, h, dh = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    p_max = block_tables.shape[1]
    check_attention_shape(q.dtype, dh, h // hkv)
    if p_max * page >= 2 ** 31:
        raise ValueError(f"a table of {p_max} pages of {page} passes the "
                         f"kernel's int32 key positions")
    out = torch.empty_like(q)
    if b == 0:                  # no row: no launch, nothing counted
        return out
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("q_pos", q_pos)):
        if not x.is_contiguous():
            raise ValueError(f"paged_flash_attention: {name} must be "
                             f"contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"paged_flash_attention: {name} must be "
                             f"16-byte aligned")
    if q.device.type == "meta":
        # q_pos holds no data: every row at full context (within its
        # window), every page of the table read
        t = p_max * page
        work.count("paged_flash_attention", work.paged_flash(
            q, k_pages, block_tables, q_pos,
            b * s * (min(t, window) if window > 0 else t), b * t))
        return out
    fn = build.load("paged_flash_attention").paged_flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), q_pos.data_ptr(),
             out.data_ptr(), b, s, h, hkv, dh, page, p_max, n_pool,
             int(window), 1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_attention launch failed: error "
                           f"{err}")
    paged_flash_attention.launches += 1
    return out


def paged_flash_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          q_pos: torch.Tensor, *,
                          window: int = -1) -> torch.Tensor:
    """Model layout: q (B, S, H, dh); k_pages/v_pages (N+1, page, Hkv,
    dh); block_tables (B, P) int32, -1 = unmapped; q_pos (B, S) int32, -1
    = a pad row.  Returns (B, S, H, dh).

    CUDA tensors launch the Hopper kernel (or raise), meta tensors take
    the meta branch (``kernels.__init__``); CPU tensors take the plain
    version.  A batch of no rows launches nothing.  No training path
    reaches paged attention, so there is no backward: under grad it
    raises (``grad.py``).  ``paged_flash_attention.launches`` counts the
    launches."""
    _check(q, k_pages, v_pages, block_tables, q_pos)
    if q.device.type == "cpu":
        return paged_flash_attention_plain(q, k_pages, v_pages, block_tables,
                                           q_pos, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no paged_flash_attention for device {q.device}")
    refuse_grad("paged_flash_attention", q, k_pages, v_pages)
    return _launch(q, k_pages, v_pages, block_tables, q_pos, window)


paged_flash_attention.launches = 0
