"""lp_realize_ms: wall time per schedule of the LP's realization inside
the serial finish (the device->host copy of the [G, T] assignment and
models/solver._realize_lp_dense), counting 0 for a schedule where it did not
run, read from the program's `host.finish.lp_realize` spans
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(trace):
    if program_spans.mean_ms(trace, "host.finish") is None:
        return None
    return program_spans.mean_ms(trace, "host.finish.lp_realize", absent_is_zero=True)
