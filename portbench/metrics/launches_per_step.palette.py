"""Device operations (kernels, copies, fills) in the traced window per optimizer step."""


def read(r):
    if r.trace is None or r.window.units == 0:
        return None
    return r.trace.device_ops / r.window.units
