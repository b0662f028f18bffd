"""Device time of K5's load mode and K6's grid mode on one GPU, for one or
more checkouts of the port, in turns.

    python3 -m cruise_control_tpu_torch.testing.kernel_times ROOT \
        [ROOT ...] [--turns N]

Each ROOT is a directory that holds a ``cruise_control_tpu_torch``
package: this checkout, or an unpacked ``git archive`` of another commit.
Turn t runs one fresh process per root, in the given order on even turns
and reversed on odd ones. Each process builds that root's kernels if
needed and times, from a torch.profiler trace of 20 calls (after three
untraced ones), the device time a call of the named kernels, per record:

- ``disk_load`` (K5's load mode) on the ``7k_1m_rebalance_disk`` entry of
  ``testing/reference_outcomes.json`` (7,000 brokers, 1M partitions, two
  log dirs a broker);
- ``score_grid`` (K6's grid mode) on one eager round of
  ReplicaDistributionGoal (6 goals prior) and of
  TopicReplicaDistributionGoal (12 goals prior), every earlier goal of the
  default chain prior, at 7k/1M (2,048 sources, 512 destinations) and at
  1k/100k (2,048 sources, 250 destinations);

and prints one JSON line a root and turn (the grid's rows, the ms of each
kernel by name, their sum). The card's name and power limit come first.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_CHILD = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from cruise_control_tpu_torch.analyzer import score_grid as sg
from cruise_control_tpu_torch.analyzer.search import SearchConfig
from cruise_control_tpu_torch.model import disks as disks_mod
from cruise_control_tpu_torch.model.tensors import cluster_to_numpy
from cruise_control_tpu_torch.testing import (
    build_fixture, entry_disks, k6_goals, k6_round_inputs,
    load_reference_outcomes)
if not torch.cuda.is_available():
    sys.exit("kernel_times needs a CUDA device")
NAMES = ("count_kernel", "scan_kernel", "scatter_kernel", "balance_kernel",
         "place_kernel", "fold_kernel", "Memset (", "Memcpy DtoD",
         "panel_kernel", "score_grid_kernel")
REPS = 20


def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=2, active=REPS)) as prof:
        for _ in range(3 + REPS):
            fn()
            torch.cuda.synchronize()
            prof.step()
    per = {}
    for e in prof.key_averages():
        if e.count and any(n in e.key for n in NAMES):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            name = e.key.split("(")[0] if "::" not in e.key else \
                e.key.split("::")[1].split("(")[0]
            per[name] = per.get(name, 0.0) + us / e.count / 1e3 \
                * max(1, round(e.count / REPS))
    return {"ms": sum(per.values()), "kernels": per}


dev = torch.device("cuda")
refs = load_reference_outcomes()
out = {}
ref = refs["7k_1m_rebalance_disk"]
state, meta = build_fixture(ref, dev)
disks = disks_mod.disks_from_numpy(entry_disks(ref, cluster_to_numpy(state)),
                                   dev)
out["k5_load_7k_1m_d2"] = device_ms(lambda: disks_mod.disk_load(state,
                                                                 disks))
del disks
for name, entry, dests in (("k6_grid_7k_1m", "7k_1m", 512),
                           ("k6_grid_1k_100k", "1k_100k", 250)):
    state, meta = build_fixture(refs[entry], dev)
    goals = k6_goals("default", state.num_brokers)
    for goal in ("ReplicaDistributionGoal", "TopicReplicaDistributionGoal"):
        active = [g.name for g in goals].index(goal)
        rec = k6_round_inputs(state, goals, active, meta.num_topics,
                              SearchConfig(num_sources=2048, num_dests=dests,
                                           moves_per_round=2048))
        (r0, c0), (r1, c1) = rec["grid"][8].layout
        out[f"{name}_{goal}"] = dict(
            rows=r0 * c0 + r1 * c1, layout=[[r0, c0], [r1, c1]],
            prior_goals=active,
            **device_ms(lambda: sg.score_grid(*rec["grid"])))
        del rec
    del state
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for turn in range(args.turns):
        for root in args.roots if turn % 2 == 0 else args.roots[::-1]:
            res = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stderr[-4000:], file=sys.stderr)
                return res.returncode
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"root": root, "turn": turn, "card": card,
                              **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
