"""Share of the profiled slice in which no operation ran on the device:
1 minus the union of device intervals over the slice's host time, in %."""


def read(records):
    prof = records.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
