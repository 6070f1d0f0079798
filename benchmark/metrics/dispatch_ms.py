"""dispatch_ms: host wall time per schedule of models/solver's
`cost_solve_dispatch` (pad, the fleet from `device_resident`, the packed
upload, the enqueue of K1, K2's pair and K3) and `plan_start_fetch` (the
non-blocking copies back), read from the benchmark's spans around them."""


def read(trace):
    return trace.ms_per_schedule("dispatch")
