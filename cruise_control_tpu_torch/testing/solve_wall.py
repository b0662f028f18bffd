"""Wall of a pinned bounded solve on one GPU, for one or more checkouts
of the port, in turns.

    python3 -m cruise_control_tpu_torch.testing.solve_wall ROOT [ROOT ...] \
        [--turns N] [--entry NAME]

Each ROOT is a directory that holds a ``cruise_control_tpu_torch`` package:
this checkout, or an unpacked ``git archive`` of another commit. A ROOT
may end in ``@KEY=VALUE[,KEY=VALUE...]``: config keys set on top of the
reference's config in that root's runs, so one checkout can be compared
with itself under another setting (for example
``. .@solver.dispatch.async.readback=false``). Turn t
runs one fresh process per root, in the given order on even turns and
reversed on odd ones (A B, B A, ...), so two commits are compared on one
card in alternation. Each process builds that root's kernels if needed,
solves the entry NAME (default ``1k_100k``) of
``testing/reference_outcomes.json`` with its config and chain
(``solver.dispatch.target.seconds=0``) once to warm up and once timed, and
prints one JSON line: root, turn, wall seconds, the goals' summed and
per-goal durations (``GoalResult.duration_s``: the rest of the wall is
the solve's work outside the goal loop), rounds and whether the
assignment digest equals the reference's. The card's name and power limit
come first. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_CHILD = r"""
import json, sys, time
import torch
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.testing import (
    build_fixture, digest, load_reference_outcomes)
if not torch.cuda.is_available():
    sys.exit("solve_wall needs a CUDA device")
from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS
ref = load_reference_outcomes()[sys.argv[2]]
conf = dict(ref["config"], **json.loads(sys.argv[1]))
opt = GoalOptimizer(CruiseControlConfig(conf), device="cuda")
goals = [ALL_GOALS[g]() for g in ref["chain"]] if "chain" in ref else None
for timed in (False, True):
    state, meta = build_fixture(ref, torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.time()
    final, result = opt.optimizations(state, meta, goals)
    torch.cuda.synchronize()
    wall = time.time() - t0
print(json.dumps({"wall_s": wall,
                  "goals_s": sum(g.duration_s for g in result.goal_results),
                  "goal_s": {g.name: round(g.duration_s, 4)
                             for g in result.goal_results},
                  "rounds": sum(g.rounds for g in result.goal_results),
                  "assignment_equal": digest(final.assignment.cpu().numpy())
                  == ref["assignment_sha256"]}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--entry", default="1k_100k")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for turn in range(args.turns):
        order = args.roots if turn % 2 == 0 else args.roots[::-1]
        for spec in order:
            root, _, sets = spec.partition("@")
            overrides = dict(kv.split("=", 1) for kv in sets.split(",")
                             if kv)
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, json.dumps(overrides),
                 args.entry],
                cwd=root, capture_output=True, text=True, check=True)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"root": spec, "entry": args.entry,
                              "turn": turn, "card": card, **line}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
