"""The design-space generator's core (twins of ``repro.core``): function
specs and bounds, the §II envelopes and feasibility, the §III decision
procedure, the batched / fleet / pooled region engines and the
``TableDesign`` artifact. Numpy only; the ``pallas`` engine's device work
lives in ``repro_torch.kernels.dspace``."""
