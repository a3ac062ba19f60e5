"""engine.steps_per_tick.decode: decode steps per tick over the window,
from the engine's counters (its `decode_steps` and `ticks` at the window's
edges)."""


def read(run):
    a, b = run["stats"]
    ticks = b["ticks"] - a["ticks"]
    return (b["decode_steps"] - a["decode_steps"]) / ticks if ticks else None
