"""The work of one call of each Hopper kernel: the bytes it must move
(each input read once, each output written once) and the operations it
does, with the type whose peak rate bounds those operations.

``chip_smoke.py`` divides them by the card's rates for each kernel's
bound, and the meta branch of every kernel wrapper counts them for the
dry run's step pass (``count_calls``), where no kernel launches.  Where
the work depends on the data, the caller passes what its inputs need:
the keys a decode call's contexts hold, the live rows and experts of an
expert product.  A meta tensor holds no data, so the meta branches
count the most the shapes allow: every slot of a ring (within its
window), every page of a block table, every row and expert of the
dispatch buffer, every page of a paged flash call's table with every
row at full context; ``flash`` and ``scan`` depend on the shapes alone.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import NamedTuple

import torch


class Work(NamedTuple):
    nbytes: float
    ops: float
    dtype: torch.dtype        # the type whose peak rate bounds ``ops``


# the dry run's counters of the calls made inside ``count_calls``
_COUNTERS: list = []


@contextlib.contextmanager
def count_calls():
    """Within the block, every kernel call a wrapper's meta branch makes,
    as {kernel name: {"calls", "ops", "bytes"}}."""
    calls: dict = {}
    _COUNTERS.append(calls)
    try:
        yield calls
    finally:
        _COUNTERS.remove(calls)


def count(name: str, work: Work) -> None:
    """Count one call of kernel ``name`` in every open ``count_calls``."""
    for calls in _COUNTERS:
        c = calls.setdefault(name, {"calls": 0, "ops": 0.0, "bytes": 0.0})
        c["calls"] += 1
        c["ops"] += work.ops
        c["bytes"] += work.nbytes


def paged_decode(q, k_pages, block_tables, ctx_lens, keys: int) -> Work:
    """K/V of the ``keys`` valid keys over the rows, q, out, tables and
    ctx, against 4 * G * dh f32 operations per valid key and KV head."""
    _, _, hkv, dh = k_pages.shape
    g = q.shape[2] // hkv
    nbytes = (2 * keys * hkv * dh * k_pages.element_size()
              + 2 * q.numel() * q.element_size()
              + block_tables.numel() * 4 + ctx_lens.numel() * 4)
    return Work(nbytes, 4 * g * dh * keys * hkv, torch.float32)


def paged_flash(q, k_pages, block_tables, q_pos, pairs: int,
                keys: int) -> Work:
    """K/V of the ``keys`` live keys (those some row of their sequence
    attends), q, out, the tables and q_pos read or written once, against
    4 * dh operations per valid (row, key) pair of each query head: two
    for q.k, two for p.v.  ``pairs`` counts the (row, key) pairs over the
    batch."""
    h, dh = q.shape[2], q.shape[3]
    hkv = k_pages.shape[2]
    nbytes = (2 * keys * hkv * dh * k_pages.element_size()
              + 2 * q.numel() * q.element_size()
              + block_tables.numel() * 4 + q_pos.numel() * 4)
    return Work(nbytes, 4 * dh * h * pairs, q.dtype)


@lru_cache(maxsize=256)
def flash_valid_keys(s: int, t: int, causal: bool, window: int) -> int:
    """Valid (query row, key) pairs of one head."""
    if not causal:
        return s * t
    total = 0
    for i in range(s):
        hi = min(i, t - 1)
        lo = max(i - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def flash(q, k, causal: bool, window: int) -> Work:
    """q, k, v read once and out written once, against 4 * dh operations
    per valid (row, head, key): two for q.k, two for p.v."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    ops = 4 * dh * b * h * flash_valid_keys(s, t, causal, window)
    return Work(nbytes, ops, q.dtype)


def flash_backward(q, k, causal: bool, window: int) -> Work:
    """q, k, v, out, dout read once, lse and D, dq, dk, dv written once;
    10 * dh operations per valid (row, head, key): QK^T and dO V^T, and
    P^T dO, dS^T Q and dS K, two per element each."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 2 * b * h * s * 4
    ops = 10 * dh * b * h * flash_valid_keys(s, t, causal, window)
    return Work(nbytes, ops, q.dtype)


def ring_decode(q, k, kpos, q_pos, keys: int) -> Work:
    """K/V of the ``keys`` valid slots, q, out, kpos and q_pos, against
    4 * G * dh f32 operations per valid slot and KV head."""
    hkv, dh = k.shape[2], k.shape[3]
    g = q.shape[2] // hkv
    nbytes = (2 * keys * hkv * dh * k.element_size()
              + 2 * q.numel() * q.element_size()
              + kpos.numel() * 4 + q_pos.numel() * 4)
    return Work(nbytes, 4 * g * dh * keys * hkv, torch.float32)


def combine(outs, lses) -> Work:
    """Each rank's partial and log-sum-exp read once, the output written
    once; about 4 operations per rank and element."""
    r, b, h, dh = outs.shape
    nbytes = (outs.numel() * outs.element_size() + lses.numel() * 4
              + b * h * dh * outs.element_size())
    return Work(nbytes, 4 * r * b * h * dh, torch.float32)


def stored_bytes(x: torch.Tensor) -> int:
    """Bytes a call must read of ``x``: a broadcast head axis once."""
    n = x.numel() // x.shape[2] if x.ndim == 4 and x.stride(2) == 0 \
        else x.numel()
    return n * x.element_size()


def scan(q, k, v, log_a, h0, chunk: int) -> Work:
    """q, k (once per broadcast row), v, log_a and h0 read once, y and
    h_T written once, against the operations of the chunked form: 2 *
    (dk + dv) per causal (i, j) pair of a chunk for the scores and the
    intra-chunk y, 4 * dk * dv per token for the inter-chunk y and the
    state update."""
    b, t, h, dk = q.shape
    dv = v.shape[3]
    pairs = sum(n * (n + 1) // 2 for n in
                (min(chunk, t - c0) for c0 in range(0, t, chunk)))
    nbytes = (sum(stored_bytes(x) for x in (q, k, v, log_a, h0))
              + v.numel() * v.element_size() + h0.numel() * 4)
    ops = b * h * (2 * (dk + dv) * pairs + 4 * t * dk * dv)
    return Work(nbytes, ops, q.dtype)


def scan_backward(q, k, v, states) -> Work:
    """q, k (once per broadcast row), v, dy, log_a and the forward's chunk
    states read; dq, dk (full shape), dv and dlog_a written; against the
    chunked form's operations: per (token, head) 2 * chunk * (dk + dv)
    for the pair matrices, 2 * chunk * (2 dk + dv) for the three chunk
    products (about half the pairs are causal: counted whole, as the
    kernel computes them) and 8 * dk * dv for U and the three state
    terms."""
    b, t, h, dk = q.shape
    dv = v.shape[3]
    chunk = min(128, t)
    el = v.element_size()
    nbytes = (stored_bytes(q) + stored_bytes(k) + 2 * v.numel() * el
              + b * t * h * 4 + states.numel() * 4
              + 2 * b * t * h * dk * el + v.numel() * el + b * t * h * 4)
    ops = b * t * h * (2 * chunk * (3 * dk + 2 * dv) + 8 * dk * dv)
    return Work(nbytes, ops, q.dtype)


def grouped_matmul(x, w, counts, rows: int, live: int) -> Work:
    """The weights of the ``live`` experts, the ``rows`` live rows of x,
    all of out and counts, against 2 * rows * d * f operations."""
    e, c, d = x.shape
    f = w.shape[2]
    nbytes = ((live * d * f + rows * d + e * c * f) * x.element_size()
              + counts.numel() * 4)
    return Work(nbytes, 2 * rows * d * f, x.dtype)


def grouped_matmul_backward(x, w, counts, rows: int, live: int,
                            part: str = "both") -> Work:
    """dX and dW together (``part`` "both"), dX alone ("dx": the live
    experts' weights and the live rows of dout read, all of dx written,
    2 * rows * d * f operations) or dW alone ("dw": the live rows of x
    and dout read, all of dw (E * d * f) written, as many operations).
    Together: the live experts' weights, the live rows of x and dout
    read once, dx and dw written, 4 * rows * d * f operations."""
    e, c, d = x.shape
    f = w.shape[2]
    dx_bytes = live * d * f + rows * f + e * c * d
    dw_bytes = rows * (d + f) + e * d * f
    elems = {"both": live * d * f + rows * (d + f) + e * c * d + e * d * f,
             "dx": dx_bytes, "dw": dw_bytes}[part]
    ops = (4 if part == "both" else 2) * rows * d * f
    return Work(elems * x.element_size() + counts.numel() * 4, ops, x.dtype)


def live_rows(counts, c: int) -> tuple[int, int]:
    """(rows, live experts) of an expert product: from ``counts`` where
    it holds data, else (a meta tensor) every row of every expert."""
    if counts.device.type == "meta":
        return counts.numel() * c, counts.numel()
    return int(counts.clamp(0, c).sum()), int((counts > 0).sum())
