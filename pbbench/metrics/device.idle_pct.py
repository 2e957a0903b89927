"""Share of the traced window in which no kernel, copy or set ran on the
device, in %: 100 minus the union of the device operations over the
window."""


def read(m):
    if m.trace is None:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
