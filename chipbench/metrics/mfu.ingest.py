"""The model step of signing (Stage 1 + Stage 2 forward): 2 x N
operations for each non-pad token of a new block and each set element
(`yardstick`'s parameter counts), over the window's seconds, over the
card's peak at the configuration's dtype, in percent."""
from chipbench import yardstick


def read(run):
    c, cfg = run.counts, run.cell.config
    s1, s2 = cfg["stage1"], cfg["stage2"]
    flops = 2 * (yardstick.stage1_params(s1) * c["stage1_tokens"]
                 + yardstick.stage1_block_params(s1) * c["new_blocks"]
                 + yardstick.stage2_element_params(s2) * c["set_elements"]
                 + yardstick.stage2_set_params(s2) * c["intervals"])
    if c["window_s"] <= 0:
        return None
    return 100.0 * flops / (c["window_s"] * yardstick.PEAK_FLOPS[s1["dtype"]])
