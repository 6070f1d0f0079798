"""host_wait_ms: the host scoring's share of the critical path: the time
per schedule the solve's own thread waited for the overlap thread (the pool
matrix and the mix candidate) after its fetch, read from the program's
`host.wait` spans (benchmark/program_spans.py)."""

from benchmark import program_spans


def read(trace):
    return program_spans.mean_ms(trace, "host.wait")
