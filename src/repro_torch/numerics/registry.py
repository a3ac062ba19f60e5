"""Table registry: the shim over the ``repro_torch.api`` Explorer (twin of
``repro/numerics/registry.py``).

The disk and memory cache lives in the Explorer session
(:meth:`repro_torch.api.Explorer.get_table`) and the per-kind defaults in
:data:`repro_torch.api.config.DEFAULTS`; this module re-exports both, so
``from repro_torch.numerics.registry import get_table`` resolves a table
the way the reference's seed-era import does (same key format, same
``artifacts/tables`` layout).
"""
from __future__ import annotations

from repro_torch.api.config import DEFAULTS, spec_for  # noqa: F401
from repro_torch.core.table import TableDesign


def get_table(kind: str, bits: int | None = None,
              lookup_bits: int | None = None, degree: int | None = None,
              **kw) -> TableDesign:
    """Fetch (generating and verifying if needed) the table for ``kind``
    from the process-wide default Explorer."""
    from repro_torch.api import default_explorer

    return default_explorer().get_table(kind, bits, lookup_bits, degree, **kw)
