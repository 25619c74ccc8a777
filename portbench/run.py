"""Runs one cell of BENCHMARK.json once and prints the result as the last
line of standard output:

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

(or `python3 -m portbench.run ...` from the checkout's root). Exits 2,
printing no result, when the card the cell asks for is missing; 3 when the
measured process loaded JAX or the JAX package.
"""

import os
import sys
import time

T_START = time.monotonic()
# one string hashing for every run: dict and set orders inside the server,
# and with them its work, then repeat from run to run of a seed (random
# per process, they spread the runs' times). The interpreter reads the
# setting only at its start, so the process starts itself once more with
# it, carrying the time it began.
if os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["PORTBENCH_T_START"] = repr(T_START)
    os.execv(sys.executable, [sys.executable] + sys.argv)
T_START = float(os.environ.pop("PORTBENCH_T_START", T_START))
_HERE = os.path.dirname(os.path.abspath(__file__))
_CHECKOUT = os.path.dirname(_HERE)
# the checkout's root, not this folder, on the path: modules here must not
# shadow any other by their bare names
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)
if _CHECKOUT not in sys.path:
    sys.path.insert(0, _CHECKOUT)


def run_env() -> dict:
    """The measured process's environment, set before numpy or torch load:
    build and kernel caches at fixed paths inside the checkout, and one
    thread in the CPU operators' pools (the server's request threads
    already share the host's cores with the client; pools of eight
    spinning beside them widened the runs' spread, PERF.md)."""
    base = os.path.join(_CHECKOUT, "build", "portbench-cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
            "OPENBLAS_NUM_THREADS": "1"}


def split_cores():
    """The client's core apart from the server's: this thread (and every
    thread and process it starts from now on) keeps to all the cores this
    process may use but the first, which the client process gets, so
    that the server's threads and the client's never take turns on a
    core. None, and nothing changed, with fewer than two cores."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        return None
    os.sched_setaffinity(0, cores[1:])
    return {cores[0]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(run_env())
    client_cpus = split_cores()

    from portbench.harness import bench, spec

    b = spec.Bench(os.path.join(_CHECKOUT, "BENCHMARK.json"))
    try:
        result = bench.run(b, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START,
                           client_cpus=client_cpus)
    except bench.NoDevice as e:
        print(f"no device: {e}", file=sys.stderr)
        return 2
    except bench.Forbidden as e:
        print(f"forbidden modules: {e}", file=sys.stderr)
        return 3
    print(bench.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
