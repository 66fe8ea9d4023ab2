"""The lane groups of the narrow-row kernels: how many lanes a row takes.

K1 / K1h (csrc/tbe_lookup.cu) and, in csrc/fused_update.cu, the row-update
kernel of K2, K3, K3h and K4's scaled RMW (`row_update_kernel`), the fused
rowwise Adagrad of K4 / K4h (`rowwise_adagrad_narrow_kernel`) and the
moment kernel of K6 / K7 (`moment_update_kernel`) hold a row as quads of
4 columns, one quad per lane. A row of D columns has ceil(D / 4) quads
and takes G lanes, the smallest power of two that covers them, at most
32, so a warp holds P = 32 / G rows at once:

    D <= 4: G = 1, 32 rows       D 17-32: G = 8, 4 rows
    D 5-8:  G = 2, 16 rows       D 33-64: G = 16, 2 rows
    D 9-16: G = 4, 8 rows        D > 64:  G = 32, one row a warp

Lane l of a group holds quad l, so a column's arithmetic is the same at
every G (and the fused kernel's sum of g^2 over a row, whose butterfly
runs inside the group). The wrappers take G from here and pass it to the
launch: the geometry comes from D alone, never from a failed launch.
"""

from __future__ import annotations

WARP = 32


def lanes_per_row(D: int) -> int:
    """G: the smallest power of two >= ceil(D / 4), at most 32."""
    if D < 1:
        raise ValueError(f"a row has at least one column, got D={D}")
    quads = -(-D // 4)
    lanes = 1
    while lanes < quads and lanes < WARP:
        lanes *= 2
    return lanes


def rows_per_warp(D: int) -> int:
    """P = 32 / G: the rows (K1: bags) a warp holds at once."""
    return WARP // lanes_per_row(D)
