"""
Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result
(JSON); the last lines of standard error are the numbers compared with the
plain reference, each beside its limit. Exits with 2, printing no result,
without the CUDA cards the cell asks for, and with 3 if a module of JAX or
of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # Every build and kernel cache at a fixed path inside the checkout (the
    # port's own kernels build into build/torch_kernels there).
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")

    import torch

    marks = [("import torch", time.perf_counter())]
    import iscc_search_tpu_torch  # noqa: F401  (the program: fail before any work without it)

    marks.append(("import the program", time.perf_counter()))
    from portbench import harness

    marks.append(("import the harness", time.perf_counter()))

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell, _, _, _ = harness.resolve(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(spec, args.workload, args.seed, args.seconds, args.trace, "cuda", T0,
                                      marks=marks)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
