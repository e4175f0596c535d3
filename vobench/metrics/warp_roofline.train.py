"""The banded warps' share of their roofline in training: the summed
bound of one step's warps, forward and backward (vobench.roofline.
train_step_warps_s), times the steps profiled, over the device time of
the banded warp kernels in the slice, in %."""

from vobench.roofline import train_step_warps_s


def read(records):
    prof = records.get("profile")
    if not prof:
        return None
    busy = sum(s for name, s, _ in prof["kernels"] if "banded_warp_" in name)
    if busy <= 0:
        return None
    cell = records["cell"]
    bound = train_step_warps_s(cell["model"], cell["train"], cell["traffic"]["batch"]) * prof["steps"]
    return 100.0 * bound / busy
