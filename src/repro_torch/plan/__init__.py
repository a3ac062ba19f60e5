"""Per-layer heterogeneous numerics (twin of ``repro.plan``): plan schema,
resolution, auto-assign.

``repro_torch.plan.schema`` imports only the standard library (imported by
``configs.base``); ``repro_torch.plan.numerics`` resolves a plan into
backend objects; the budget-driven auto-assigner lives in
``repro_torch.plan.assign``. Both load lazily.
"""
from repro_torch.plan.schema import (PLAN_BACKENDS, PLAN_SCHEMA, SITE_KINDS,
                                     SITES, LayerAssign, NumericsPlan,
                                     SiteAssign, SlotSpec, load_plan,
                                     plan_for, save_plan)

__all__ = [
    "PLAN_BACKENDS", "PLAN_SCHEMA", "SITE_KINDS", "SITES", "LayerAssign",
    "NumericsPlan", "SiteAssign", "SlotSpec", "load_plan", "plan_for",
    "save_plan", "auto_plan", "plan_numerics", "compile_plan_libraries",
    "PlanNumerics", "SiteNumerics", "PlanReport",
]


def __getattr__(name):
    if name in ("plan_numerics", "compile_plan_libraries", "PlanNumerics",
                "SiteNumerics"):
        from repro_torch.plan import numerics as _n

        return getattr(_n, name)
    if name in ("auto_plan", "PlanReport"):
        from repro_torch.plan import assign as _a

        return getattr(_a, name)
    raise AttributeError(name)
