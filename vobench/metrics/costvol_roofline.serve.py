"""The cost volumes' share of their roofline in unfused serving: the
summed bound of one forward's cost volumes (vobench.roofline.
serving_costvols_s, bf16 maps) times the batches profiled, over the
device time of `cost_volume_kernel` in the slice, in %."""

from vobench.roofline import serving_costvols_s


def read(records):
    prof = records.get("profile")
    if not prof:
        return None
    busy = sum(s for name, s, _ in prof["kernels"] if "cost_volume_kernel" in name)
    if busy <= 0:
        return None
    cell = records["cell"]
    return 100.0 * serving_costvols_s(cell["model"], cell["traffic"]["batch"]) * prof["steps"] / busy
