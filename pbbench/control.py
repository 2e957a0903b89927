"""The control of a cell's check, on the card, in one process.

    python3 pbbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--program]

The control is the port with its own ``--nodp`` path switched on
(``CorrectionParams.no_dp``): a gap that the FM walks cannot close is left
as the raw read where pbcorrect runs the MSA/DP fallback, the step a later
change might be tempted to skip.  For each seed it runs a window of the
cell's traffic with the control in the program's place and compares a
sample of the reads it finished with the reference, as ``run.py`` does; a
sound check reads it as not correct.  With ``--program`` the program's own
window and check run beside it on each seed.  The data set and the index
are opened once for all seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ in ("__main__", "__mp_main__"):
    sys.path[0] = ROOT

from pbbench import run  # noqa: E402


def readings(s: run.Opened, seeds, seconds: float, program: bool,
             workers: int = run.check.WORKERS) -> list[dict]:
    params = s.cell.config["pbcorrect"]
    sides = ([("program", params)] if program else []) + [("control", {**params, "no_dp": True})]
    out = []
    for seed in seeds:
        for side, p in sides:
            corrector, window, rng_check = run.start(s, p, seed)
            w = window(seconds)
            s.sync()
            numbers = run.compare(s.data, params, w, rng_check, workers)
            out.append({"seed": seed, "side": side, "correct": run.passed(numbers),
                        "reads": len(w.done), "window_s": w.seconds,
                        **{k: v["value"] for k, v in numbers.items()}})
            run.say("reading " + json.dumps(out[-1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.say("control: no CUDA device")
        return 2
    s = run.open_cell(ROOT, args.workload, "cuda")
    out = readings(s, [int(x) for x in args.seeds.split(",")], args.seconds, args.program)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
