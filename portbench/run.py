"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

From the root of a checkout. The last line of standard output is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`: each number that decided
`correct` beside its limit); progress, clocks, power and the host probe go
to standard error, whose last lines are the same checks. Without a CUDA
device, or with fewer than the cell asks for, it exits 2 and prints no
result. `--control` runs the cell's control (portbench/harness/check.py)
in the program's place; the benchmark's own runs never pass it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    # one host thread for CPU work: the host's cores are shared, and the
    # calls are host-bound
    os.environ["OMP_NUM_THREADS"] = "1"
    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    import torch
    from portbench.harness import cell, spec
    torch.set_num_threads(1)

    bench = spec.benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; known: {sorted(cells)}",
              file=sys.stderr)
        return 2
    need = cells[args.workload]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"needs {need} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, T_START, bench=bench,
                   control=args.control)
    found = cell.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
