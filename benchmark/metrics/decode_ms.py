"""decode_ms: host wall time per schedule of models/solver's
`decode_dense_result`, read from the benchmark's spans around it."""


def read(trace):
    return trace.ms_per_schedule("decode")
