"""The wkv forward and backward kernels of a training step
(`kernels/wkv` -> `csrc/wkv.cu`), as one: the least time the card could
take for the recurrence's forward and backward (`yardstick.wkv_work`,
train=True, at `rows` x `max_len`) for each forward launch, over the
device time of both kinds of kernel in the trace, in percent. Nothing
when the trace holds no wkv kernel."""
from chipbench import yardstick


def read(run):
    fwd = run.trace.kernels("wkv_forward_kernel")
    bwd = run.trace.kernels("wkv_backward_kernel")
    device_s = sum(b - a for _, a, b in fwd + bwd)
    if not fwd or device_s <= 0:
        return None
    s1 = run.cell.config["stage1"]
    d = sum(s1["dim_embeds"])
    ops, nbytes = yardstick.wkv_work(
        run.cell.mix["rows"], s1["max_len"], s1["num_heads"],
        d // s1["num_heads"], s1["dtype"], train=True)
    return 100.0 * len(fwd) * yardstick.least_seconds(ops, nbytes) / device_s
