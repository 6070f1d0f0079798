"""launches_per_schedule: device records (kernels, copies and sets) that
torch.profiler saw in the traced window, per schedule completed in it."""


def read(trace):
    schedules = trace.window_schedules()
    if not schedules or not trace.device:
        return None
    return len(trace.device) / len(schedules)
