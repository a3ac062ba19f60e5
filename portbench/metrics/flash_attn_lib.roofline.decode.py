"""flash_attn_lib.roofline.decode: the least time of the traced steps'
`flash_attn_lib` launches (`portbench.work`: live K/V rows, q and the output
once; FLOPs 2(D + Dv) per live pair and head) over the profiler's time of
the flash kernels."""
from portbench import derive


def read(run):
    return derive.flash_roofline(run)
