"""Run one cell of BENCHMARK.json once on the card(s) and print its result.

    python3 port_bench/run.py --workload dcf20.eval --seed 7 --seconds 10 \\
        --trace 0

Run from the root of a checkout that holds the port (``fss_tpu_torch``).
Set-up (the port's libraries from ``build/fss_tpu_torch/``, the inputs made
on the device from the seed, the cell's shapes warmed) runs first; then
the measured window of ``--seconds``; then the check of the kept outputs
against the reference. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s``, ``window_s``, and a ``breakdown``
beside it) and, last, ``checks``: each number compared, with its limit,
as the last lines of standard error say too.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or when jax, jaxlib, flax or fss_tpu was loaded.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "port_bench" / "cache"


def _environment() -> None:
    """Every cache a run could fill stays at a fixed path in the checkout;
    no library of the run may pull in JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # Import port_bench as a package from the checkout's root, never its
    # modules by their bare names (``trace`` is also a standard module).
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != ROOT / "port_bench"]
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    marks = {"torch": time.monotonic()}

    from port_bench import harness
    cell = harness.Cell.find(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    marks["cuda"] = time.monotonic()
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T0, marks=marks)
    notes = out["notes"]
    forbidden = harness._forbidden()
    if forbidden:
        print(f"port_bench: modules loaded that the port may not use: "
              f"{forbidden}", file=sys.stderr)
        return 3
    line = out["line"]
    print(json.dumps({"setup": notes["setup"], "check_s": notes["check_s"],
                      "kernels_missing": notes["missing"]}),
          file=sys.stderr)
    for name, c in line["checks"].items():
        what = notes["what"].get(name, "")
        print(f"check {name} {c['value']} limit {c['limit']} {what}".rstrip(),
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
