"""The Graphormer cell's model FLOPs (benchmark/roofline_graphormer.py: the
products over the real rows, the attention over the real pairs and the
head, of every step's forward and backward and of each validation pass)
over the wall time of the traced window's epochs before the profiled one
(whose time the profiler's own work inflates), and the H100's 67 TFLOP/s
f32 peak without the tensor cores."""


def read(run: dict):
    if run.get("kind") != "finetune_graphormer" or not run.get("window_s"):
        return None
    return 100.0 * run["model_flops"] / run["window_s"] / run["peak_flops"]
