"""encode_ms: host wall time per schedule of ops/encode's `group_pods` and
`build_fleet`, read from the benchmark's spans around them."""


def read(trace):
    return trace.ms_per_schedule("encode")
