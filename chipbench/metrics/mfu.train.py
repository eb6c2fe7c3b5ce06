"""The model step of pre-training: 6 x N operations for each non-pad
token trained on (N: `yardstick.pretrain_params`), over the window's
seconds, over the card's peak at the configuration's dtype, in
percent."""
from chipbench import yardstick
from chipbench.reference.tokenizer import DIM_SIZES


def read(run):
    c, s1 = run.counts, run.cell.config["stage1"]
    if c["window_s"] <= 0:
        return None
    flops = 6 * yardstick.pretrain_params(s1, DIM_SIZES[0]) * c["tokens"]
    return 100.0 * flops / (c["window_s"] * yardstick.PEAK_FLOPS[s1["dtype"]])
