"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  The last line of standard output is the result object;
the numbers compared for ``correct`` are the last lines of standard
error.  Without a card, with a forbidden module loaded, or without the
port beside the benchmark, it exits with another code than 0 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from portbench import harness


def main(argv=None) -> int:
    t_proc = harness.process_start_wall()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from portbench import guard
    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds,
                                  bool(a.trace), t_proc=t_proc)
    except harness.HarnessError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    found = guard.forbidden()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
