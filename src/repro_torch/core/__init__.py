"""The design-space generator's core (twins of ``repro.core``): function
specs and bounds, the §II envelopes and feasibility, the §III decision
procedure, the batched / fleet / pooled region engines and the
``TableDesign`` artifact. Numpy only; the ``pallas`` engine's device work
lives in ``repro_torch.kernels.dspace``.

The public entry point is ``repro_torch.api``; this package exports the
reference's names:
    get_spec            — fixed-point function specifications (funcspec)
    run_decision        — §III decision procedure, policy-driven (decision)
    regions_feasible    — Eqns 9-10 feasibility (designspace)
    generate_remez_table— FloPoCo-style Remez baseline (remez)
Legacy shims (generate_table, sweep_lub, generate_for_r, min_feasible_r)
delegate to the default Explorer and stay importable from here.
"""
from repro_torch.core.decision import run_decision  # noqa: F401
from repro_torch.core.designspace import (build_design_space,  # noqa: F401
                                          minimal_k, regions_feasible)
from repro_torch.core.funcspec import FunctionSpec, get_spec  # noqa: F401
from repro_torch.core.generate import (GenResult,  # noqa: F401
                                       generate_for_r, generate_table,
                                       min_feasible_r, sweep_lub)
from repro_torch.core.remez import generate_remez_table  # noqa: F401
from repro_torch.core.table import TableDesign  # noqa: F401
