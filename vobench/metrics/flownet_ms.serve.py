"""Device ms of the flow net per batch (CUDA events recorded by forward
hooks on `model.flownet`), mean over the traced run's batches."""


def read(records):
    ms = records.get("batches", {}).get("flownet_ms")
    return sum(ms) / len(ms) if ms else None
