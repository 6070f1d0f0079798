"""pack_rounds_roofline: the pack round loop's share of its roofline, both
modes (greedy and cost) together. The bound is max(operations / 67 TFLOP/s,
bytes / 3.35 TB/s) for the rounds these inputs took, counted over the groups
still holding pods at each round and the instance types kept (the dispatch
and fetch spans' readings); the time is the device time of the window's
records whose name holds "pack_rounds_kernel" (K2's pair launch with the K4
epilogue, ops/pack_kernel). Summed over the window's schedules."""

from benchmark import roofline

KERNEL = "pack_rounds_kernel"


def read(trace):
    device_s = trace.kernel_seconds(KERNEL)
    dispatch = {s["schedule"]: s["info"] for s in trace.spans_of("dispatch") if s["info"]}
    fetch = {s["schedule"]: s["info"] for s in trace.spans_of("fetch") if s["info"]}
    both = [(dispatch[k], fetch[k]) for k in dispatch if k in fetch]
    if device_s <= 0 or not both:
        return None
    bound = 0.0
    for shape, rounds in both:
        groups, types, dims = shape["groups"], shape["types"], shape["dims"]
        operations = roofline.pack_operations(
            rounds["cells_ffd"], types, rounds["rounds_ffd"], groups, dims, cost_mode=False
        ) + roofline.pack_operations(rounds["cells_cost"], types, rounds["rounds_cost"], groups, dims, cost_mode=True)
        nbytes = roofline.pack_bytes(groups, types, dims, [rounds["rounds_ffd"], rounds["rounds_cost"]])
        bound += roofline.bound_seconds(operations, nbytes)
    return 100.0 * bound / device_s
