"""The port's hand-written layer kernels' share of their roofline in the
profiled pretraining sub-window: the least time their launches' work
needs (benchmark/roofline.py, from each view's counts) over their device
time (kernels in the `fbl::` namespace, from the trace). In cell
gcn.pretrain_node_b512 (GCN, node masking)."""


def read(run: dict):
    if run.get("kind") != "pretrain" or not run.get("port_kernel_s"):
        return None
    return 100.0 * run["bound_s"] / run["port_kernel_s"]
