"""Device milliseconds a step of the kernels launched under the program's
`graphormer.bias` ranges (the attention bias's distance and multi-hop
terms, forward and backward), in eager steps after the window."""


def read(run: dict):
    if run.get("kind") != "finetune_graphormer" \
            or not run.get("bias_device_s"):
        return None
    return 1e3 * run["bias_device_s"] / run["eager_steps"]
