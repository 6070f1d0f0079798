"""device_idle_pct: 100 x (1 - the time in which any device record ran /
the traced window), from torch.profiler's records of the window."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
