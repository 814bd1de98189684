"""The head dims and GQA groups the attention kernels take.

Every kernel is instantiated at head widths 32, 64, 128 and 256 and
runs any head dim ``dh`` from 1 to 256 on the narrowest width that holds
it, with the lanes or columns past ``dh`` idle (so kimi-k2's dh 112 and
h2o-danube-3's 120 run on the 128 one, reading q, the pool and the rings
in place, and Gemma 3's 256 on the 256 one).  A dh above 256 runs in
column blocks (``col_blocks``): each CTA owns a block of the output's
columns and computes the whole row's scores, so one body takes any
number of blocks (the decode kernels' blocks are 256 wide; flash's 256
in bf16 and 64 in f32, its backward's 64).  A multiple of 8 keeps every
row start 16-byte aligned in f32 and bf16.  Any other dh the two decode
kernels read in place too, element by element; the flash forward and
backward, whose bf16 tiles arrive by 16-byte copies and tensor maps, get
a zero-padded copy of their activations at the next multiple of 8 from
the wrapper (the reference pads every dh to a multiple of 128).  The
decode kernels take the query heads of a GQA group in chunks, as
``group_chunk`` chooses; flash takes G at run time, so every G runs.

What is refused, each for its cause: a dtype other than f32 and bf16, a
dh or G below 1, a decode grid past 65535 rows (``check_grid``), and a
decode head so wide that a chunk's q rows pass the shared memory its
wide CTA holds them in (``check_decode_shape``: dh up to 9728 at 5 heads
a chunk, 12288 at 4).
"""
from __future__ import annotations

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widest instantiated body; a wider head runs in column blocks of it
BLOCK_WIDTH = 256
# shared memory a wide decode CTA holds its chunk's q rows in, f32, whole
# blocks (csrc/common.cuh WIDE_Q_SMEM)
WIDE_Q_SMEM = 192 * 1024
# the groups of the repo's configs and of the shapes the kernels are held
# at; any G >= 1 runs.  3: Llama 3.2 3B (24 query heads over 8); 5:
# hymba-1.5b (25 over 5); 6: qwen2-vl-2b; 7: arctic-480b (56 over 8); 8:
# kimi-k2 (64 over 8); 9: a group in chunks of 3 + 3 + 3; 12:
# command-r-plus; 16: llama3-405b; 48: StarCoder's multi-query 48 heads
# over 1
GROUPS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 48)


def check_attention_shape(dtype: torch.dtype, dh: int, g: int) -> None:
    """Raise ``ValueError`` for a (dtype, dh, G) no kernel takes: a dtype
    other than f32 and bf16, a dh below 1, a G below 1."""
    if dtype not in DTYPES or dh < 1 or g < 1:
        raise ValueError(f"no kernel for dtype {dtype}, dh {dh}, G {g} "
                         f"(dtypes {list(DTYPES)}, any dh >= 1, any "
                         f"G >= 1)")


def col_blocks(dh: int) -> int:
    """The decode kernels' column blocks of a head: 1 up to
    ``BLOCK_WIDTH``, else ``ceil(dh / BLOCK_WIDTH)`` CTAs a row."""
    return 1 if dh <= BLOCK_WIDTH else -(-dh // BLOCK_WIDTH)


def check_decode_shape(dtype: torch.dtype, dh: int, g: int) -> None:
    """``check_attention_shape``, and for a dh past ``BLOCK_WIDTH`` the
    shared memory of the decode kernels' wide CTA: its chunk's q rows, f32
    over whole blocks, must fit ``WIDE_Q_SMEM``."""
    check_attention_shape(dtype, dh, g)
    if dh > BLOCK_WIDTH:
        gc = group_chunk(g)
        need = gc * col_blocks(dh) * BLOCK_WIDTH * 4
        if need > WIDE_Q_SMEM:
            raise ValueError(f"no decode kernel for dh {dh}, G {g}: the q "
                             f"rows of a chunk of {gc} heads take {need} "
                             f"bytes of shared memory, past the "
                             f"{WIDE_Q_SMEM} a wide CTA holds them in")


def group_chunk(g: int) -> int:
    """Query heads a decode CTA takes: the whole group up to 5 heads, else
    the fewest chunks of at most 4, ``ceil(g / n)`` heads each, the last
    one holding what is left (G = 6 runs as 3 + 3, 7 as 4 + 3, 8 as 4 + 4,
    9 as 3 + 3 + 3, 12 and 16 as three and four chunks of 4, 48 as twelve).
    Measured in bf16 on an H100 (``PERF.md`` §6): the state of 7 or 8
    heads in one CTA takes 186-227 registers a thread and was slower than
    chunks of 4 that each read the K/V rows again, mostly from L2, at
    every context tried; 5 heads were faster whole.  At qwen2-vl-2b's
    heads (G = 6, Hkv 2, dh 128) chunks of 3 were the fastest of 2 to 5 in
    both decode kernels, at long and serve contexts alike.  Shapes only,
    as plain ints."""
    if type(g) is not int:
        raise TypeError(f"group_chunk takes ints; g is {type(g).__name__}")
    if g <= 0:
        raise ValueError(f"g must be positive, got {g}")
    if g <= 5:
        return g
    n = -(-g // 4)
    return -(-g // n)


def check_grid(hkv: int, g: int, gc: int, dh: int = 1) -> None:
    """Raise ``ValueError`` where a decode kernel's grid would pass its
    limit: one CTA row per (KV head, chunk of ``gc`` query heads, column
    block of dh), at most 65535."""
    rows = hkv * -(-g // gc) * col_blocks(dh)
    if rows > 65535:
        raise ValueError(f"no kernel for {hkv} KV heads x {-(-g // gc)} "
                         f"group chunks x {col_blocks(dh)} column blocks: "
                         f"{rows} grid rows, at most 65535")


def pad_width(dh: int) -> int:
    """The head dim the flash kernels run a ``dh`` at: ``dh`` rounded up
    to a multiple of 8 (its rows 16-byte aligned in f32 and bf16)."""
    return -(-dh // 8) * 8
