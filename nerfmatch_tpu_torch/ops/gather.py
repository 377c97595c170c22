"""Row gathers (counterpart of ``nerfmatch_tpu/ops/gather.py``; the TPU
one-hot backward is not needed: autograd's index backward is a plain
scatter-add on the GPU)."""

from __future__ import annotations


def take_rows(table, idx):
    """``table[idx]`` for a 2-D ``table (N, C)`` and int ``idx (L,)``."""
    return table[idx.long()]


def take_rows_b(table_b, b_ids, r_ids):
    """``table_b[b_ids, r_ids]`` for ``table_b (B, M, C)``."""
    B, M, C = table_b.shape
    return take_rows(table_b.reshape(B * M, C), b_ids.long() * M + r_ids.long())
