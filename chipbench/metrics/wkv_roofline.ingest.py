"""The wkv forward kernels (`kernels/wkv` -> `csrc/wkv.cu`): the least
time their launches could take on the card (`yardstick.wkv_work` at the
encoder's batch, every launch a batch of `encode_batch` blocks of
`max_len` tokens) over their device time in the trace, in percent.
Nothing when the trace holds no wkv forward kernel."""
from chipbench import yardstick


def read(run):
    fwd = run.trace.kernels("wkv_forward_kernel")
    device_s = sum(b - a for _, a, b in fwd)
    if not fwd or device_s <= 0:
        return None
    s1 = run.cell.config["stage1"]
    d = sum(s1["dim_embeds"])
    ops, nbytes = yardstick.wkv_work(
        run.cell.config["service"]["encode_batch"], s1["max_len"],
        s1["num_heads"], d // s1["num_heads"], s1["dtype"], train=False)
    return 100.0 * len(fwd) * yardstick.least_seconds(ops, nbytes) / device_s
