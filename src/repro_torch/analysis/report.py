"""Render the dry-run's roofline table from artifacts/dryrun_torch/*.json
(port of `repro.analysis.report`; the fit is against the H100's 80 GB).

    PYTHONPATH=src python -m repro_torch.analysis.report [DIR]

Every number in the table is derived from the H100 data sheet's constants
and the step's counted work (`launch/dryrun.py`), not measured.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.analysis.costs import H100_SXM

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def load(dirpath: str):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def render(rows, mesh_filter=None) -> str:
    out = ["| arch | shape | mesh | dom | compute_s | memory_s | collective_s "
           "| roofline | MFU_ub | useful/counted | GB/device | fit |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if mesh_filter and d.get("mesh") != mesh_filter:
            continue
        if d["status"].startswith("SKIP"):
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                       f"{d['status']} | | | | | | | | |")
            continue
        if d["status"] != "OK":
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
                       f"FAIL | | | | | | | | |")
            continue
        r = d["roofline"]
        t = r["terms"]
        gb = (r["argument_bytes"] + r["temp_bytes"]) / 1e9
        fit = "FITS" if gb * 1e9 < H100_SXM.hbm_bytes else "OVER"
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {t['dominant']} | "
            f"{t['compute_s']:.3f} | {t['memory_s']:.2f} | "
            f"{t['collective_s']:.2f} | {t['roofline_fraction']:.3f} | "
            f"{t['mfu_upper_bound']:.3f} | {t['useful_flops_ratio']:.3f} | "
            f"{gb:.1f} | {fit} |")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rows = load(argv[0] if argv else ARTIFACT_DIR)
    print(render(rows))
    ok = sum(1 for r in rows if r["status"] == "OK")
    skip = sum(1 for r in rows if r["status"].startswith("SKIP"))
    fail = sum(1 for r in rows if r["status"].startswith("FAIL"))
    print(f"\n{ok} OK, {skip} SKIP, {fail} FAIL; derived from the "
          f"{H100_SXM.name} data sheet's constants, not measured; each "
          f"cell's \"model_axis\" says whether its ranks along \"model\" "
          f"compute their shares or the same rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
