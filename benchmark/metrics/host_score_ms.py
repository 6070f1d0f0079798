"""host_score_ms: host wall time per schedule of the scoring on the host:
models/solver's `_pool_price_matrix` and `compute_mix_candidate` (ops/mix_pack;
both in the overlap thread, beside the fetch's wait) and `cost_solve_finish`,
read from the benchmark's spans around them."""


def read(trace):
    return trace.ms_per_schedule("host_score")
