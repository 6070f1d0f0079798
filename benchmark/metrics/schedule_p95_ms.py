"""schedule_p95_ms: the 95th percentile of the wall time of
`CostSolver.solve` over every schedule of the window, on the host's clock.
Reported only where the window holds at least 200 schedules, so that ten or
more lie beyond it."""

import statistics

MIN_SCHEDULES = 200


def read(trace):
    walls = [s["end"] - s["start"] for s in trace.window_schedules()]
    if len(walls) < MIN_SCHEDULES:
        return None
    return 1e3 * statistics.quantiles(walls, n=20)[18]
