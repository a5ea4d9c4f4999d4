"""Readings that set a cell's limits. For each of ``--runs`` runs, the
traffic's ``check_pricings`` consecutive seeds are priced by the program and
by the control (the plain reference computed in bfloat16, the nearest
precision below the configuration's float32, in the program's place); each
side is judged against the plain reference in float64 (``Route.judge``) and
its numbers are taken over the run's pricings as a benchmark run takes them
(``check.judge``). One JSON line a run, then the largest program reading and
the smallest control reading of each number.

    python3 -m perfbench.control --workload <cell> --seed <first> --runs <count>

Not part of a benchmark run: run it on the card at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from perfbench import check, run


def readings(cell: run.Cell, first_seeds, device) -> list:
    route = cell.route.Route(cell.config, device)
    route.price(run.WARM_SEED_OFFSET + first_seeds[0])
    k = int(cell.traffic["check_pricings"])
    rows = []
    for s0 in first_seeds:
        seeds = range(s0, s0 + k)
        prog = [route.judge(s, route.price(s)) for s in seeds]
        ctrl = [route.judge(s, route.control(s)) for s in seeds]
        names = {n: math.inf for n in prog[0]}
        rows.append({"seed": s0, "program": {n: v["value"] for n, v in
                                             check.judge(prog, names)[1].items()},
                     "control": {n: v["value"] for n, v in
                                 check.judge(ctrl, names)[1].items()}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = run.Cell(run.load_manifest(), args.workload)
    t0 = time.perf_counter()
    rows = readings(cell, [args.seed + 1000 * i for i in range(args.runs)],
                    torch.device(args.device))
    for r in rows:
        print(json.dumps(run._finite(r)))
    summary = {n: {"program_max": max(r["program"][n] for r in rows),
                   "control_min": min(r["control"][n] for r in rows),
                   "limit": cell.limits.get(n)} for n in rows[0]["program"]}
    print(json.dumps({"workload": cell.name, "runs": len(rows), "summary": run._finite(summary),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
