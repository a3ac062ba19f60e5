"""device.idle_share.decode: the traced stretch minus the union of the
device's kernel, copy and fill intervals, over the stretch."""
from portbench import derive


def read(run):
    return derive.idle_share(run)
