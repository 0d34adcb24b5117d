"""The check's control on the card: the plain reference in the program's
place at the precision below the configuration's (bfloat16 for float32),
driven through a run of the cell at its own size, on each seed given.  Its
numbers are the upper readings the check's limits are set from; it has to
come out not correct.  The benchmark's own runs never run it.

    python3 wbench/control.py --workload <name> --seeds <a,b,c>

Prints one JSON line a seed: the seed, ``correct`` and the numbers compared.
"""

import argparse
import json
import os
import sys
import time

#: the control's window: long enough for the mix's requests and as many
#: compared as a run compares
WINDOW_S = 2.0
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from wbench import cells, harness
    from wbench.system import ReferenceSystem

    if not torch.cuda.is_available():
        print("the control runs on the card: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.cell(cells.benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = harness.run_cell(cell, seed, WINDOW_S, False, device="cuda",
                                t_start=time.perf_counter(), system_class=ReferenceSystem)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"], "checks": line["checks"]}),
              flush=True)
        harness.free_device(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
