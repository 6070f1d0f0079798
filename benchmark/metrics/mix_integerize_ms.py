"""mix_integerize_ms: wall time per schedule of the mix candidate's
integerization (ops/mix_pack.integerize_cover's greedy cover and trim) and
its emission of rounds, read from the program's `host.mix.integerize` spans
(benchmark/program_spans.py)."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "host.mix.integerize")
