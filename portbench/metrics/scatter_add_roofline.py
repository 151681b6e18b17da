"""The hash-grid backward's scatter kernel (``csrc/scatter_add.cu``) against its byte
bound: the least time of one read of the step's update stream at the card's bandwidth
(``costs.scatter_bound_s``) over the kernel's device time per launch in the traced
window, in %. The table's zero-fill is a kernel of its own and is in neither. Nothing
when no launch of it ran."""

from portbench import costs


def read(r):
    per_launch = None if r.trace is None else r.trace.per_launch_s("scatter_add_")
    if not per_launch:
        return None
    return 100.0 * costs.scatter_bound_s(r.cell.config) / per_launch
