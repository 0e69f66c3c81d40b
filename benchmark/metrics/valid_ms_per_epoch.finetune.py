"""Milliseconds per fine-tuning epoch in validation: the benchmark's clock
around each epoch's evaluate("valid") and best-state keep, to a
synchronize."""


def read(run: dict):
    if run.get("kind") != "finetune" or not run.get("valid_s"):
        return None
    return 1e3 * sum(run["valid_s"]) / len(run["valid_s"])
