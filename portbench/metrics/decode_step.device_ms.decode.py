"""decode_step.device_ms.decode: device ms per decode step: the kernels
the profiler correlates with each traced `step()`'s last graph launch (its
tick's replay), over the decode steps those ticks ran."""
from portbench import derive


def read(run):
    return derive.tick_device_ms(run)
