"""Device operations (kernels, copies and sets) per training step, as
the profiler records them in the slice."""


def read(records):
    prof = records.get("profile")
    if not prof or not prof["steps"]:
        return None
    launches = sum(n for _, _, n in prof["kernels"])
    return launches / prof["steps"] if launches else None
