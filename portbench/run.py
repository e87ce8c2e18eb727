"""One run of one benchmark cell of the port, orca_tpu_torch:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is the result's JSON object; the
numbers compared with the plain reference, each beside its limit, are the
last lines of standard error. Exits non-zero with no result when CUDA or
the cards are missing, when the run fails, or when JAX or the JAX package
was loaded.
"""

import time

T0 = time.monotonic()  # set-up is counted from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.cell_spec(harness.load_manifest(ROOT), args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = harness.run_cell(spec, args.seed, args.seconds,
                                  bool(args.trace), T0)
    except Exception:
        harness.log(traceback.format_exc())
        return 1
    found = harness.forbidden_modules()
    if found:
        harness.log("loaded in this process, and not allowed: "
                    + ", ".join(found))
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
