"""The control of a cell's comparison, and the readings its limits are set
from. The control is the plain reference computed in the precision below
the cell's (the traffic mix's `control`: float8 e4m3 for a bfloat16 cell,
TF32 for a float32 one), put in the program's place and held to the cell's
limits, which it has to fail. Run on the card at the cell's own size, a few
seeds in one process:

    python3 -m portbench.control --workload <name> --seeds 11,12,13

For each seed it builds the cell as a run does, answers the first
`check_requests` requests through the program's timed path and then
through the control, holds both to the limits through the harness's own
comparison (`harness.check`, the reference run once for both), and prints
one JSON line: each side's numbers beside the limits and its verdict.
Exits 0 when every seed's program is correct and every seed's control is
not. The benchmark's own runs never run it.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def calibrate(spec: dict, seed: int, device: str = "cuda") -> dict:
    """The program's and the control's numbers on one seed's requests."""
    import torch

    from portbench import harness

    traffic = spec["traffic"]
    driver = harness.load_driver(traffic)(spec["config"], traffic, seed,
                                          device)
    driver.warmup()
    requests = [driver.request(i) for i in range(traffic["check_requests"])]
    program = [(r, driver.answer(driver.call(r))) for r in requests]
    driver.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    control = [(r, driver.reference(r, traffic["control"]))
               for r in requests]
    memo: dict = {}
    out = {"seed": seed, "control": traffic["control"]}
    for side, answers in (("program", program), ("control", control)):
        checks = harness.check(driver, answers, seed, traffic, memo)
        out[side] = checks
        out[f"{side}_correct"] = harness.within(checks)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from portbench import harness

    spec = harness.cell_spec(harness.load_manifest(), args.workload)
    as_expected = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        line = calibrate(spec, seed, args.device)
        as_expected &= line["program_correct"] and not line["control_correct"]
        line.update(workload=args.workload, s=time.monotonic() - t)
        print(json.dumps(line), flush=True)
    return 0 if as_expected else 1


if __name__ == "__main__":
    sys.exit(main())
