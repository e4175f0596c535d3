"""The fused serving chains' share of their roofline: the summed bound of
one forward's `conv_chain_strided` and `flow_level_fused` calls
(vobench.roofline.fused_serving_chains_s) times the batches profiled,
over the device time of their kernels (rowconv.cu's) in the slice, in %."""

from vobench.roofline import fused_serving_chains_s

KERNELS = ("flow_level_input", "conv_mma_", "conv_tf32_")


def read(records):
    prof = records.get("profile")
    if not prof:
        return None
    busy = sum(s for name, s, _ in prof["kernels"] if any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    cell = records["cell"]
    bound = fused_serving_chains_s(cell["model"], cell["traffic"]["batch"]) * prof["steps"]
    return 100.0 * bound / busy
