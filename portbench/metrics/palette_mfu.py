"""The whole training step's model FLOPs (``costs.train_step_flops``) at the window's
rate of steps, as a share of the card's published dense bf16 peak, in %."""

from portbench import costs


def read(r):
    if r.window.units == 0:
        return None
    rate = r.window.units / r.window.seconds
    return 100.0 * costs.train_step_flops(r.cell.config) * rate / costs.PEAK_BF16_FLOPS
