"""Host ms from a batch's dispatch until the serving closure returns its
pose tensor (before the read-back), mean over the traced run's batches."""


def read(records):
    ms = records.get("batches", {}).get("dispatch_ms")
    return sum(ms) / len(ms) if ms else None
