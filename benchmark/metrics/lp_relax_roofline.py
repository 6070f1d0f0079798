"""lp_relax_roofline: the LP relaxation's share of its roofline. The bound is
max(operations / 67 TFLOP/s, bytes / 3.35 TB/s) for the LP these inputs need,
at the groups that hold pods and the instance types kept, as the dispatch
span saw them; the time is the device time of the window's records whose
name holds "lp_relax_kernel" (K3, ops/score_kernel), the kernel that does the
LP's work on one card. Summed over the window's schedules."""

from benchmark import roofline

KERNEL = "lp_relax_kernel"


def read(trace):
    device_s = trace.kernel_seconds(KERNEL)
    spans = [s for s in trace.spans_of("dispatch") if s["info"]]
    if device_s <= 0 or not spans:
        return None
    bound = sum(
        roofline.bound_seconds(
            roofline.lp_operations(s["info"]["groups"], s["info"]["types"], s["info"]["dims"]),
            roofline.lp_bytes(s["info"]["groups"], s["info"]["types"], s["info"]["dims"]),
        )
        for s in spans
    )
    return 100.0 * bound / device_s
