"""The Graphormer attention's share of its roofline in eager steps after
the window: the least time of its work on the steps' batches (the real
pairs and their q / k / v / bias / output bytes, forward and backward,
benchmark/roofline_graphormer.py) over the device time of the kernels
launched under the program's `graphormer.attn` ranges, forward and
backward."""


def read(run: dict):
    if run.get("kind") != "finetune_graphormer" \
            or not run.get("attn_device_s"):
        return None
    return 100.0 * run["attn_bound_s"] / run["attn_device_s"]
