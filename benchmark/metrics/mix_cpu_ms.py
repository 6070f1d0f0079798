"""mix_cpu_ms: the overlap thread's own CPU time in the mix candidate per
schedule (time.thread_time around models/solver.compute_mix_candidate), read
from the `cpu_s` of the program's `host.mix` spans
(benchmark/program_spans.py). Near the span's wall time unless the thread
waited for a core."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "host.mix", attribute="cpu_s")
