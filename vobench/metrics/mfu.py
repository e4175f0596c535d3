"""The whole step's share of the H100's dense bf16 peak, in %: the
operations of one unit of work (a pair posed, a snippet trained; the
driver gives `flops_per_unit` from vobench.flops) times the units done
in the traced run's window outside the profiled slice, over those
seconds times the peak. The slice, which the profiler slows, is left out."""

from vobench.roofline import BF16_FLOPS


def read(records):
    units = records.get("units", 0) - records.get("slice_units", 0)
    seconds = records.get("window_s", 0.0) - records.get("profile", {}).get("window_s", 0.0)
    if units <= 0 or seconds <= 0 or not records.get("flops_per_unit"):
        return None
    return 100.0 * records["flops_per_unit"] * units / (seconds * BF16_FLOPS)
