"""The control of each cell's check, and the planted faults at the cell's
own size. The control is the plain reference put in the program's place a
precision below the configuration's float32 (each driver's
``control_outputs``: the filter in bfloat16 throughout; SMC2's lane
filters in bfloat16), held against the float32 reference by the cell's own
comparison at the cell's own sizes. It has to read above a limit; its
readings are the upper ones the limits were set under.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--fault state_unchanged]

prints one JSON line a seed with the compared numbers: of the control, or,
with ``--fault``, of a run of the cell (one round of passes) with that
fault of ``tests/faults.py`` planted in the program. It needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import spec


def readings(cell: spec.Cell, seed: int, device: str) -> dict:
    """The compared numbers of the control at ``seed``, ``{name: value}``,
    or ``{"error": message}`` where the control raised (a control that
    crashes has failed, and gives no number)."""
    driver = cell.driver()(None, cell.config, cell.traffic, None, cell.reference(), device, seed)
    sample = driver.sample(max(int(cell.traffic["checked_passes"]), int(cell.traffic["datasets"])))
    try:
        outputs = driver.control_outputs(sample)
    except RuntimeError as e:
        return {"error": f"{type(e).__name__}: {e}"}
    return {name: value for name, value, _ in driver.compare(sample, outputs, cell.limits)}


def fault_readings(cell: spec.Cell, seed: int, fault: str, device: str) -> dict:
    """The compared numbers of one run of the cell with ``fault`` planted."""
    from benchmark import run
    from benchmark.tests import faults

    with faults.FAULTS[fault]():
        result = run.run_cell(cell, seed, 0.0, False, device)
    return {name: check["value"] for name, check in result["checks"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault")
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        if args.fault:
            found = {"fault": args.fault, "readings": fault_readings(cell, seed, args.fault, "cuda")}
        else:
            found = {"control": readings(cell, seed, "cuda")}
        print(json.dumps({"workload": cell.name, "seed": seed, **found, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
