"""The activation-table window and output spans (subset of
``repro/core/funcspec.py``).

Only the constants the runtime float glue reads are ported in this slice;
the bound makers port with the generator.
"""
from __future__ import annotations

# Input window of the direct activation tables (silu / sigmoid / softplus /
# gelu / tanh): codes map affinely onto [ACT_LO, ACT_HI).
ACT_LO, ACT_HI = -8.0, 8.0
ACT_KINDS = ("silu", "sigmoid", "softplus", "gelu", "tanh")


def act_out_span(kind: str, lo: float = ACT_LO, hi: float = ACT_HI) -> float:
    """Output span S of a direct activation table: the stored integer is
    ``value * 2^out_bits / S``. sigmoid's range is (0, 1), tanh's (-1, 1);
    the others scale by the input window width."""
    if kind not in ACT_KINDS:
        raise KeyError(f"{kind!r} is not a direct activation table")
    if kind == "sigmoid":
        return 1.0
    if kind == "tanh":
        return 2.0
    return hi - lo
