"""mfu.decode: model FLOPs of every token delivered inside the window
(prefill and decode, `portbench.work`) over the window's seconds times
the bf16 peak."""
from portbench import derive, work


def read(run):
    lo, hi = run["window"]
    return 100.0 * derive.window_flops(run) / ((hi - lo) * work.PEAK_FLOPS)
