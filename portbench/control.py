"""The readings that a cell's limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each seed, the cell's inputs as a run makes them, one call of the
timed entry on each batch (the program's reading) or of the entry's
``control`` (the same call one precision lower), each compared with the
reference as a run compares it.  Prints one line a seed and, last, the
largest program reading and the smallest control reading of each compared
number as JSON.  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import core, generator  # noqa: E402


def readings(cell: core.Cell, seeds, device, control: bool) -> list[dict]:
    """Per seed, the worst error of each group over the cell's batches."""
    fn = cell.entry.control if control else cell.entry.call
    out = []
    for seed in seeds:
        inputs = generator.make_inputs(cell.cfg, cell.mix, seed, device)
        worst: dict = {}
        for x in inputs:
            result = fn(x, cell.cfg, cell.mix)
            core.sync(device)
            (errors,) = core.compare(cell.entry, cell.cfg, cell.mix, x, [result])
            del result
            for g, e in errors.items():
                worst[g] = max(worst.get(g, 0.0), e)
        out.append(worst)
        del inputs
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    x = generator.make_inputs(cell.cfg, cell.mix, seeds[0], args.device)[0]
    cell.entry.call(x, cell.cfg, cell.mix)  # the kernels' build and first launch
    del x
    summary = {"workload": args.workload}
    for label, group, is_control in (("program", seeds, False),
                                     ("control", control_seeds, True)):
        t0 = time.perf_counter()
        rows = readings(cell, group, args.device, is_control)
        for seed, r in zip(group, rows):
            print(f"{label} seed {seed}: " + json.dumps(r), flush=True)
        pick = max if label == "program" else min
        summary[label] = {g: pick(r[g] for r in rows) for g in rows[0]}
        summary[f"{label}_seconds"] = time.perf_counter() - t0
    if torch.device(args.device).type == "cuda":
        summary["device"] = torch.cuda.get_device_name(args.device)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
