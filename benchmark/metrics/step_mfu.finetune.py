"""The whole traced fine-tuning window's model FLOPs (the matrix products
of every member step's forward and backward and of each validation pass
over M members, benchmark/roofline.py) over its wall time and the H100's
67 TFLOP/s f32 peak without the tensor cores."""


def read(run: dict):
    if run.get("kind") != "finetune" or not run.get("window_s"):
        return None
    return 100.0 * run["model_flops"] / run["window_s"] / run["peak_flops"]
