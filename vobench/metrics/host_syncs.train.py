"""Blocking runtime calls per training step (stream, device and event
synchronisations, as the profiler counts them in the slice), less those
that profiling a bare synchronise counts."""

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def read(records):
    prof = records.get("profile")
    if not prof or not prof["steps"]:
        return None
    calls = sum(n for name, n in prof["runtime"].items() if name in SYNC_CALLS)
    return (calls - prof.get("sync_baseline", 0)) / prof["steps"]
