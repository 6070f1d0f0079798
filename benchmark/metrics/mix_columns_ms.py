"""mix_columns_ms: wall time per schedule of the mix candidate's columns
(ops/mix_pack: the pair enumeration, the coarse and the dual-value pruning,
the exact pricing, the rescue and seed columns), read from the program's
`host.mix.columns` spans (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "host.mix.columns")
