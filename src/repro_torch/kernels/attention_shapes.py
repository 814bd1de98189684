"""The head dims and GQA groups the three attention kernels take.

Every kernel is instantiated at head widths 32, 64 and 128 and runs any
head dim ``dh`` that is a multiple of 8 up to 128 on the narrowest width
that holds it, with the lanes or columns past ``dh`` idle (so kimi-k2's
dh 112 and h2o-danube-3's 120 run on the 128 one, reading q, the pool
and the rings in place).  The decode kernels take the query heads of a
GQA group in chunks, as ``group_chunk`` chooses; flash takes G at run
time.  A multiple of 8 keeps every row start 16-byte aligned in f32 and
bf16.
"""
from __future__ import annotations

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM_MAX = 128
# G = 5: hymba-1.5b (25 query heads over 5 KV heads); 6: qwen2-vl-2b;
# 7: arctic-480b (56 over 8); 8: kimi-k2 (64 over 8); 12: command-r-plus;
# 16: llama3-405b
GROUPS = (1, 2, 4, 5, 6, 7, 8, 12, 16)


def check_attention_shape(dtype: torch.dtype, dh: int, g: int) -> None:
    """Raise ``ValueError`` for a (dtype, dh, G) no kernel takes."""
    if dtype not in DTYPES or dh % 8 or not 8 <= dh <= HEAD_DIM_MAX \
            or g not in GROUPS:
        raise ValueError(f"no kernel for dtype {dtype}, dh {dh}, G {g} "
                         f"(dtypes {list(DTYPES)}, dh a multiple of 8 up to "
                         f"{HEAD_DIM_MAX}, G {GROUPS})")


def group_chunk(g: int) -> int:
    """Query heads a decode CTA takes: the whole group up to 5 heads, else
    the fewest chunks of at most 4, ``ceil(g / n)`` heads each, the last
    one holding what is left (G = 6 runs as 3 + 3, 7 as 4 + 3, 8 as 4 + 4,
    12 and 16 as three and four chunks of 4).  Measured in bf16 on an H100
    (``PERF.md`` §6): the state of 7 or 8 heads in one CTA takes 186-227
    registers a thread and was slower than chunks of 4 that each read the
    K/V rows again, mostly from L2, at every context tried; 5 heads were
    faster whole.  At qwen2-vl-2b's heads (G = 6, Hkv 2, dh 128) chunks
    of 3 were the fastest of 2 to 5 in both decode kernels, at long and
    serve contexts alike.  Shapes only, as plain ints."""
    if type(g) is not int:
        raise TypeError(f"group_chunk takes ints; g is {type(g).__name__}")
    if g <= 0:
        raise ValueError(f"g must be positive, got {g}")
    if g <= 5:
        return g
    n = -(-g // 4)
    return -(-g // n)
