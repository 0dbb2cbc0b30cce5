"""
The control of a cell's comparison: the plain reference in the program's
place, computed a precision lower than its configuration states, judged as
a run judges the program. It has to come out as not correct.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--device cuda]

For each seed it makes the cell's data and request pool, takes the sample a
run of that seed would check (every sampled item answered), and prints the
numbers compared beside their limits; then, per number, the smallest over
the seeds: the upper reading that a limit is set below.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control_numbers(spec, workload, seed, device, config_over=None, mix_over=None):
    """The numbers compared for the control on ``seed``: {name: value}."""
    import torch

    from portbench import harness
    from portbench.systems.units import seed_rng

    _, config, mix, _ = harness.resolve(spec, workload)
    config.update(config_over or {})
    mix.update(mix_over or {})
    system = importlib.import_module(f"portbench.systems.{config['system']}")
    reference = importlib.import_module(f"portbench.reference.{config['reference']}")
    dev = torch.device(device)
    data = system.make_data(config, seed, dev)
    pool = system.make_pool(data, config, mix, seed)
    items = sum(len(r) for r in pool.requests)
    checked = [int(i) for i in seed_rng(seed, 2).permutation(items)[: pool.sample]]
    ref = reference.answers(data, pool, checked, config, mix, dev)
    control = reference.control_answers(data, pool, checked, config, mix, dev)
    return reference.judge(data, pool, checked, control, ref, config, mix), config["limits"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from portbench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    upper = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers, limits = control_numbers(spec, args.workload, seed, args.device)
        failed = [n for n, v in numbers.items() if v > limits[n]]
        print(f"control {args.workload} seed {seed}: {json.dumps(numbers)} limits {json.dumps(limits)}; "
              f"{'not correct (' + ', '.join(failed) + ')' if failed else 'CORRECT'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, value in numbers.items():
            upper[name] = min(upper.get(name, value), value)
    print(f"control {args.workload} upper readings (least over the seeds): {json.dumps(upper)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
