"""fetch_ms: host wall time per schedule of models/solver's `fetch_plan`,
which waits for the card and unpacks the compacted plan, read from the
benchmark's spans around it."""


def read(trace):
    return trace.ms_per_schedule("fetch")
