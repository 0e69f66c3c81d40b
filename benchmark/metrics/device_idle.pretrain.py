"""The share of the profiled pretraining sub-window in which no kernel,
copy or fill runs on the device (torch.profiler's CUDA activity). In
cell gin.pretrain_node_b512 (GIN, node masking)."""


def read(run: dict):
    if run.get("kind") != "pretrain" or not run.get("busy_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["profiled_window_s"])
