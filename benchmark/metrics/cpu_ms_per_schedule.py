"""cpu_ms_per_schedule: the process's CPU time (every thread's, as
time.process_time reads it) from the window's start to the end of the last
schedule that completed inside it, per such schedule. It counts the host
work a schedule costs, and not the time the process waited for a core, so it
spreads less than the wall-clock rate on a host whose cores are shared."""


def read(trace):
    schedules = trace.window_schedules()
    if not schedules or "cpu_end" not in schedules[-1]:
        return None
    return 1e3 * schedules[-1]["cpu_end"] / len(schedules)
