"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (and ``breakdown`` when
traced), and ``checks`` last: each number compared with the reference
beside its limit. The same numbers close standard error. Exits non-zero,
printing no result, where there is no CUDA card, fewer cards than the cell
asks for, or where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """The port's defaults and its bundled tuned store (no ``FFPA_TORCH_*``
    override), nothing that loads JAX, and every build cache inside the
    checkout at a fixed path."""
    for key in [k for k in os.environ if k.startswith("FFPA_TORCH_")]:
        del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from perfbench import harness

    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA card: nothing measured")
        return 3
    chips = int(spec["cell"]["chips"])
    if torch.cuda.device_count() < chips:
        harness.log(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")
        return 3
    card = harness.card_info()
    harness.log(f"card {card['kind']}, power limit {card['power_limit']}")
    res = harness.run_cell(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           t0=T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules that a run may not load were loaded: {', '.join(found)}")
        return 4
    win = res["window"]
    ph = res["setup_phases"]
    harness.log(f"setup_s {win.setup_s!r}: to the harness {ph['start']!r}, program state and "
                f"inputs {ph['state']!r}, warm-up steps {ph['warmup']!r}")
    harness.log(f"steps {win.steps} in {win.window_s!r} s, {win.tokens} tokens")
    q = sorted(win.step_ms)
    slowest = max(range(len(win.step_ms)), key=win.step_ms.__getitem__)
    harness.log(f"step_ms min {q[0]!r} median {q[len(q) // 2]!r} max {q[-1]!r} "
                f"(step {slowest} of {len(q)})")
    gcs = res["full_gc_ms"]
    harness.log(f"full garbage collections in the window {len(gcs)}, longest "
                f"{max(gcs, default=0.0)!r} ms")
    harness.log(f"memory_peak_bytes {res['memory_peak_bytes']}")
    harness.log(f"samples compared {res['samples']}")
    line = harness.result_line(res, card["kind"], chips)
    for name, c in line["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
