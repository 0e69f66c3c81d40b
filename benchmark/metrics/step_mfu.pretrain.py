"""The whole traced pretraining window's model FLOPs (the matrix products
of every step's forward and backward and of each validation pass,
benchmark/roofline.py) over its wall time and the H100's 67 TFLOP/s f32
peak without the tensor cores. In cell gin.pretrain_node_b512 (GIN, node
masking)."""


def read(run: dict):
    if run.get("kind") != "pretrain" or not run.get("window_s"):
        return None
    return 100.0 * run["model_flops"] / run["window_s"] / run["peak_flops"]
