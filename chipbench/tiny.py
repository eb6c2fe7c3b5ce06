"""A cell of BENCHMARK.json cut to a size the CPU runs in a second or
two, for the benchmark's own tests: every width and count divided down,
the cell's traffic kind, driver and limits as they are."""
from __future__ import annotations

import copy

from chipbench import bench


def cell(name: str) -> bench.Cell:
    full = bench.Cell.find(name)
    c = copy.deepcopy(full.config)
    c["stage1"].update(dim_embeds=[24, 8, 8, 8, 8, 8], num_layers=2,
                       num_heads=2, bbe_dim=32, max_len=32)
    c["stage2"].update(bbe_dim=32, d_model=32, sig_dim=16, num_heads=2,
                       max_set=16)
    c["service"].update(k=4, encode_batch=16, signature_batch=32)
    m = dict(full.mix)
    if m["kind"] == "ingest":
        m.update(base_intervals=20, pool_functions=12, library_blocks=32,
                 programs_made=2, warm_up=[8, 8],
                 blocks_per_program=[8, 24], intervals_per_program=[8, 24],
                 blocks_per_interval=[4, 16], phases=2, phase_intervals=[2, 6],
                 check_programs=2, trace_seconds=1)
    else:
        m.update(rows=8, corpus_functions=6, reference_rows=4,
                 trace_seconds=1)
    return bench.Cell(full.name, c, m, full.limits, full.chips)
