"""The benchmark of ``band_tpu_torch`` on NVIDIA cards: runs one cell once
and prints one JSON line as the last line of standard output.

    python3 portbench/run.py --workload mnv2_int8.stream --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout.  ``--trace 1`` traces part of the
window with torch.profiler and reports the per-layer metrics; ``--trace
0`` reports the end-to-end ones.  The run refuses, with no result and a
non-zero exit code, when there is no CUDA card (it never measures on the
CPU), when a module of JAX or of ``band_tpu`` is loaded, or when
anything fails.  The numbers compared with the reference are printed
with their limits as the last lines of standard error and under
``checks``, the last key of the result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that a checkout's first run builds and later runs find it."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness, spec

    chips = int({w["name"]: w for w in spec.benchmark(ROOT)["workloads"]}
                [args.workload]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no result on the CPU)", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", PROCESS_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or band_tpu loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
