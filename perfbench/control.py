"""The readings that the check's limits are set from, for one cell on the
card: the program's over many seeds (the lower reading), and its controls'
(the upper reading). Not run by the benchmark's own runs.

    python3 perfbench/control.py --workload <cell> --seeds <n> ... \\
        [--int8-seeds <n> ...] [--fault-seeds <n> ...] [--seconds 2]

Each seed runs the cell as ``run.py`` does (its full size, a short window)
and prints one JSON line: the program's numbers, and those of the
reference computed from float8 e4m3 inputs put in its place. Each
``--int8-seed`` runs the program over int8 pools instead (its own lower
precision: the control that the limits must fail). Each ``--fault-seed``
runs the program once with each fault of ``faults.py`` planted. The last
line sums up: the largest program reading, the smallest of each control
and fault.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _lowest(acc: dict, side: str, key: str, value: float) -> None:
    acc.setdefault(side, {})[key] = min(acc.get(side, {}).get(key, float("inf")), value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--int8-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for key in [k for k in os.environ if k.startswith("FFPA_TORCH_")]:
        del os.environ[key]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import faults, harness

    if not torch.cuda.is_available():
        harness.log("no CUDA card: nothing measured")
        return 3
    spec = harness.cell_spec(args.workload)
    keys = list(spec["limits"]["limits"])
    worst, least = {}, {}
    runs = ([(s, "bf16", None) for s in args.seeds] + [(s, "int8", None) for s in args.int8_seeds]
            + [(s, "bf16", f) for s in args.fault_seeds for f in faults.FAULTS])
    for seed, pool, fault in runs:
        t0 = time.perf_counter()
        sound = pool == "bf16" and fault is None
        with faults.planted(fault) if fault else contextlib.nullcontext():
            res = harness.run_cell(spec, seed=seed, seconds=args.seconds, trace=False,
                                   pool=pool, controls=("fp8",) if sound else ())
        got = {k: res["checks"][k]["value"] for k in keys}
        row = {"seed": seed, "pool": pool, "fault": fault, "correct": res["correct"],
               "steps": res["window"].steps, "samples": res["samples"], "readings": got,
               "seconds": time.perf_counter() - t0}
        for k in keys:
            if sound:
                worst[k] = max(worst.get(k, 0.0), got[k])
            else:
                _lowest(least, fault or pool, k, got[k])
        for name, ctl in res["control_readings"].items():
            row[f"control_{name}"] = {k: ctl[k] for k in keys}
            for k in keys:
                _lowest(least, name, k, ctl[k])
        print(json.dumps(row), flush=True)
        del res
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "card": harness.card_info(),
                      "program_max": worst, "control_min": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
