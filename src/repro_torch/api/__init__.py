"""Runtime artifacts of the port (twin of ``repro.api``'s library side)."""
from repro_torch.api.library import (DEFAULT_LIBRARY_KINDS, FuncMeta,
                                     InterpLibrary, LibraryIntegrityError)

__all__ = ["DEFAULT_LIBRARY_KINDS", "FuncMeta", "InterpLibrary",
           "LibraryIntegrityError"]
