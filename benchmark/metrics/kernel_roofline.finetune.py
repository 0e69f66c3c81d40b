"""The port's hand-written layer kernels' share of their roofline in the
profiled fine-tuning sub-window: the least time their launches' work
needs (benchmark/roofline.py, from each batch's counts, M members a
launch) over their device time (kernels in the `fbl::` namespace, from
the trace)."""


def read(run: dict):
    if run.get("kind") != "finetune" or not run.get("port_kernel_s"):
        return None
    return 100.0 * run["bound_s"] / run["port_kernel_s"]
