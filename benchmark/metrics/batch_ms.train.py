"""Host milliseconds in `Trainer.sample_batch` a step of the window: the
batch's draw and the packer's wait and copy (layer: host batches)."""


def read(rec):
    t = rec.get("train")
    if not t or not t["batch_s"]:
        return None
    return 1000.0 * sum(t["batch_s"]) / len(t["batch_s"])
