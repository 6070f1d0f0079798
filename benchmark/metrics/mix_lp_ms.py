"""mix_lp_ms: wall time per schedule of the mix candidate's covering LP
(ops/mix_pack.solve_cover_lp, scipy's HiGHS), read from the program's
`host.mix.cover_lp` spans (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "host.mix.cover_lp")
