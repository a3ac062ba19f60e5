"""repro_torch.api — the public entry point of the port (twin of
``repro.api``): the design-space pipeline and its runtime artifact.

    ExploreConfig       frozen session configuration (spec, sweep, engine,
                        workers, cache dir, device)
    Target              protocol: decision-procedure ordering + area/delay
                        estimator; @register_target adds a technology
                        (built-ins: asic, fpga-lut, pallas-tpu, kept as
                        pricing models so frontiers reproduce)
    Explorer            session object owning the worker pool, the
                        (spec, R) -> RegionSpace envelope cache and the
                        table persistence layer
    DesignSpaceResult   full per-R frontier + Pareto / best / min-regions
    InterpLibrary       the compiled ROM the serving stack reads (v1
                        uniform slots, v2 segmented slots from
                        ``Explorer.compile_segmented``)
"""
from repro_torch.api.config import DEFAULTS, ExploreConfig, spec_for
from repro_torch.api.explorer import (Explorer, default_explorer, explore,
                                      get_table, set_default_explorer)
from repro_torch.api.library import (DEFAULT_LIBRARY_KINDS, FuncMeta,
                                     InterpLibrary, LibraryIntegrityError,
                                     load_library)
from repro_torch.api.result import DesignSpaceResult, ExploreEntry
from repro_torch.api.target import (Target, get_target, list_targets,
                                    register_target)
from repro_torch.core.decision import DecisionPolicy
from repro_torch.core.funcspec import FunctionSpec, get_spec
from repro_torch.core.table import TableDesign

__all__ = [
    "DEFAULTS", "DEFAULT_LIBRARY_KINDS", "DecisionPolicy",
    "DesignSpaceResult", "ExploreConfig", "ExploreEntry", "Explorer",
    "FuncMeta", "FunctionSpec", "InterpLibrary", "LibraryIntegrityError",
    "TableDesign", "Target",
    "default_explorer", "explore", "get_spec", "get_table", "get_target",
    "list_targets", "load_library", "register_target",
    "set_default_explorer", "spec_for",
]
