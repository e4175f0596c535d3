"""Device ms of the pose net per batch (CUDA events recorded by forward
hooks on `model.posenet`), mean over the traced run's batches."""


def read(records):
    ms = records.get("batches", {}).get("posenet_ms")
    return sum(ms) / len(ms) if ms else None
