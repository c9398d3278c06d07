"""The control of each cell's comparison: the reference put in the
program's place, with a guarantee of the configuration broken, must come
out as not correct.

The configurations state no precision; they state the PRG: ChaCha of 20
rounds. The control takes the step a later change could be tempted by,
fewer rounds (8 by default): the reference computes, at the cell's own
sizes and from the run's own inputs, what the program would return (the
keys or the shares), with ChaCha8; the cell's comparison then
holds that against the reference with the stated rounds. Each number it
reads is printed beside its limit, one JSON line a seed.

    python3 port_bench/control.py --workload dcf20.eval --seeds 1,2,3

The benchmark's own runs never run it.
"""

import argparse
import json
import pathlib
import sys
import time

if __name__ == "__main__":  # run as a script: the package from the root
    ROOT = pathlib.Path(__file__).resolve().parent.parent
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != ROOT / "port_bench"]
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import generator, harness  # noqa: E402


def run(workload: str, seed: int, rounds: int, device: str = "cuda",
        spec=harness.ROOT / "BENCHMARK.json", cfg=None, mix=None) -> dict:
    """The control's numbers for one seed: the reference of ``rounds``
    in the program's place, held to the cell's check."""
    cell = harness.Cell.find(workload, spec, cfg, mix)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    schedule = generator.Schedule.draw(cell.mix, seed)
    system = cell.system().System(cell.cfg, cell.mix, seed, device)
    sets = sorted({schedule.input_set(i) for i in schedule.keep})
    t = time.monotonic()
    found, failed = system.check(system.control_outputs(sets, rounds))
    return dict(seed=seed, rounds=rounds, failed=failed,
                seconds=time.monotonic() - t,
                numbers={k: {"value": v, "limit": lim, "of": what}
                         for k, (v, lim, what) in found.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run(args.workload, seed, args.rounds)
        out["workload"] = args.workload
        out["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
