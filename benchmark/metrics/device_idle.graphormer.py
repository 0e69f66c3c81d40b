"""The share of the Graphormer cell's profiled sub-window (the last window
epoch's boundary, where the train stack is refilled, and its first
steps) in which no kernel, copy or fill runs on the device
(torch.profiler's CUDA activity)."""


def read(run: dict):
    if run.get("kind") != "finetune_graphormer" or not run.get("busy_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["profiled_window_s"])
