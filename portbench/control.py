"""The control of the comparison that decides ``correct``: the plain
reference with its conv-family weights on an int4 grid (the precision
below the configurations' int8) put in the program's place, on a cell's
own pool of inputs.  Its answers go through the run's own comparison
(``Answers.judge``, ``harness.verdict``), each pool input answered once,
and it prints, per seed, the numbers compared, their limits and
``correct``; a sound control comes out not correct.

    python3 portbench/control.py --workload mnv2_int8.stream \\
        --seeds 101,102,103
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_numbers(root: str, workload: str, seed: int, device: str,
                    limit_pool: int = 0) -> dict:
    """The control's run on the pool the cell draws from ``seed`` (its
    first ``limit_pool`` inputs where that is set): ``correct`` and the
    numbers compared, with their limits."""
    from portbench import harness, spec
    from portbench.client import Answers
    from portbench.reference.tflite import read_model

    c = spec.cell(root, workload)
    model = read_model(os.path.join(root, c["config"]["model"]))
    pool = harness.make_pool(seed, model.tensors[model.inputs[0]].shape,
                             int(c["traffic"]["pool"]))
    used = range(limit_pool or len(pool))
    answers = Answers()
    got = harness.reference_outputs(model, pool, used, device, weight_bits=4)
    for p in used:
        answers.hold(p, got[p])
    want = harness.reference_outputs(model, pool, used, device)
    correct, checks = harness.verdict(answers.judge(want), 0)
    return dict(workload=workload, seed=seed, compared=len(used),
                correct=correct, checks=checks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        row = control_numbers(ROOT, args.workload, seed, args.device)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
