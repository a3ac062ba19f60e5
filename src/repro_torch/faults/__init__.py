"""repro_torch.faults: deterministic, seedable fault injection (twin of
``repro/faults``).

Injectors for the chaos tests: ROM bit flips, poisoned prompts and
activations, dropped / delayed / NaN'd serve ticks, and named crash points
that simulate a kill-9 at precise code locations. Everything is driven by
explicit seeds.
"""
from repro_torch.faults.inject import (Crashed, FaultClock,  # noqa: F401
                                       TickFaultInjector, arm_crashpoint,
                                       crashpoint, crashpoints_armed,
                                       flip_rom_bit, poison_prompt,
                                       poison_values, reset_crashpoints)
