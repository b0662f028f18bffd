"""Device time of K5's load mode, K6's grid mode, K7, K3, K2's leadership
mode and K8 on one GPU, for one or more checkouts of the port, in turns.

    python3 -m cruise_control_tpu_torch.testing.kernel_times ROOT \
        [ROOT ...] [--turns N] [--k7-only | --k3-only | --k3r-only |
        --k2l-only | --k8-only | --kd1-only | --kd2-only | --kd3-only |
        --k5-only | --kd4-only]

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
- ``slot_weights`` (K7) at 7,000 brokers / 1M partitions / 700 topics with
  the last 50 brokers DEAD, on the goal of each weight family
  (``testing.K7_FAMILY_GOALS``), with the offline override and count
  where the goal moves replicas; and, for RackAwareGoal, a LOAD_TOTAL
  and a FIT_PRIORITY goal, the round's offline work: K7's call plus, in a
  checkout whose K7 returns no count, K1's offline mode
  (``agg.offline_per_broker``), as that checkout's round runs them. Each
  K7 timing is taken twice: with the inputs left in L2 by the call before
  (``k7_...``) and with L2 flushed before every call (``k7_cold_...``: a
  256 MB add, untimed, as a round's earlier kernels leave K7's inputs
  mostly out of the 50 MB L2).

``--k7-only`` times K7 alone. ``--k3-only`` times K3 (``select_batch``)
alone, and nothing else: the wrapper's call on the inputs one eager
round of ReplicaDistributionGoal (6 goals prior) gives it at the 1k/100k
cap (2,048 sources, 250 destinations: 4,096 reduced rows, m = 2,048) and
at the 7k/1M cap (2,048 sources, 512 destinations), warm and cold
(``k3_``, ``k3_cold_``); there every device op of the call counts, the
wrapper's own PyTorch ops included, and the line gives their number a
call (``ops``); the call as the round makes it: in a tree whose K3 also
rechecks and caps, with its tail (its select part alone:
``testing/k3_phases.py``'s stop before the tail). ``--k3r-only`` times
the round's whole selection after the grid (``search.cumulative_select``
with the freeze flag set, and in a tree whose round ANDs the flag
itself, that AND too): in a tree that fuses it, one K3 call whose select
kernel also rechecks and caps; in an older one K3, K6's recheck launch
and the PyTorch ops of the cap and the flag; the same rounds and caps as
``--k3-only`` and a round at 100 brokers / 10k partitions (256 sources
and 32 destinations: 512 reduced rows, m = 256), warm and cold
(``k3r_``, ``k3r_cold_``), every device op counted. ``--k2l-only`` times
K2's leadership mode (``candidates.leadership_sources``) alone, the same
way (every device op of the call, warm and cold: ``k2l_``,
``k2l_cold_``), on DiskUsageDistributionGoal's round scores and weights
with the offline override (``testing.k2_round_inputs``) at k = 2,048: on
the 1k/100k fixture (the cap) and at 7k/1M with the last 50 brokers DEAD
(offline leaders at 1e30). ``--k8-only`` times K8
(``search.swap_top_replicas``) alone, the same way (``k8_``,
``k8_cold_``), on the inputs one eager swap round gives it:
DiskUsageDistributionGoal's (the default chain's first goal with swap
rounds, every earlier goal prior) at 1k/100k and at 7k/1M, and
KafkaAssignerDiskUsageDistributionGoal's (the kafka-assigner chain's
swap goal, its rack goal prior) at 1k/100k. ``--kd1-only`` and
``--kd2-only`` time the direct transport's KD1 (``sort_pairs``) and KD2
(``segment_scan``) alone, the same way (``kd1_``, ``kd1_cold_``,
``kd2_``, ``kd2_cold_``), on the calls one sweep of
TopicReplicaDistributionGoal's transport makes from the entry fixture of
``1k_100k`` and ``7k_1m`` (the default chain's earlier goals as its
guards): KD1's (cell, weight) mover sort and first position-keyed sort,
KD2's scan of the four load columns with the resource guards' checks;
beside each, one PyTorch call of the same size (``torch.sort`` of the
composite key; one 1-D ``torch.cumsum`` over the N * R values), which
the port never calls. ``--kd3-only`` times KD3 (``direct_plan``) alone,
the same way (``kd3_``, ``kd3_cold_``), on the plans that sweep makes
(the topic plane: 100 x 1,000 and 700 x 7,000) and on one synthetic row
of a cluster-wide count goal (G = 1; dense Poisson-30 counts, seed 0) at
1,000 and 7,000 brokers; KD3 has no PyTorch counterpart. ``--k5-only``
times K5's balancer (``disks.balance_intra_broker``) alone, the same way
(``k5_``, ``k5_cold_``; ``k5_ms`` sums K5's own device ops, its kernels,
memset and copy, apart from the wrapper's PyTorch ops), on the JBOD pair
at 7k/1M (the ``7k_1m_rebalance_disk`` entry's disks with the usage
goal's band, the ``7k_1m_remove_disks`` entry's with none, two log dirs a
broker) and on the 1k/100k fixture's seeded random placements at D = 4
(band) and D = 8 (capacity) with 10 % of partitions pinned, each line
with the rounds of the broker that ran most and how many ran more than 8.
``--kd4-only`` times KD4 (``fill.direct_fill_dests``) alone, the same way
(``kd4_``, ``kd4_cold_``), on the first call that sweep makes at 1k/100k
and 7k/1M, beside one ``torch.searchsorted`` over the rows laid end to
end (``kd4_library_``), which the port never calls. Prints one JSON
line a root and turn (the grid's rows, the ms of each kernel by name,
their sum). The card's name and power limit come first. Needs a CUDA
device; imports nothing of JAX.
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
from cruise_control_tpu_torch.analyzer import agg as agg_mod
from cruise_control_tpu_torch.analyzer import score_grid as sg
from cruise_control_tpu_torch.analyzer import slot_pass
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.derived import compute_derived
from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS
from cruise_control_tpu_torch.analyzer.search import SearchConfig, goal_aux
from cruise_control_tpu_torch.model import disks as disks_mod
from cruise_control_tpu_torch.model.fixtures import Dist, random_cluster
from cruise_control_tpu_torch.model.tensors import (
    cluster_to_numpy, set_broker_state)
from cruise_control_tpu_torch.testing import (
    build_fixture, entry_disks, k6_goals, k6_round_inputs,
    load_reference_outcomes)
if not torch.cuda.is_available():
    sys.exit("kernel_times needs a CUDA device")
NAMES = ("count_kernel", "scan_kernel", "scatter_kernel", "balance_kernel",
         "place_kernel", "fold_kernel", "Memset (", "Memcpy DtoD",
         "panel_kernel", "score_grid_kernel", "weights_kernel", "peak_kernel",
         "to_float_kernel")
FAMILY_GOALS, MODE = json.loads(sys.argv[1]), sys.argv[2]
K7_ONLY = MODE == "k7"
OFFLINE_WORK = ("RACK_DUPLICATE", "LOAD_TOTAL", "FIT_PRIORITY")
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


def device_ops(fn):
    # Device time and ops a call of every device op fn launches but the
    # cold flush's (the only float64 op).
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=2, active=REPS)) as prof:
        for _ in range(3 + REPS):
            fn()
            torch.cuda.synchronize()
            prof.step()
    per, ops = {}, 0
    for e in prof.key_averages():
        if not e.count or not str(getattr(e, "device_type", "")).endswith(
                "CUDA") or "double" in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per[e.key[:80]] = us / REPS / 1e3
        ops += e.count
    return {"ms": sum(per.values()), "ops": ops / REPS, "kernels": per}


dev = torch.device("cuda")
refs = load_reference_outcomes()
out = {}
if MODE == "k3":
    from cruise_control_tpu_torch.analyzer import agg as agg_k3
    from cruise_control_tpu_torch.analyzer import chain as chain_k3
    from cruise_control_tpu_torch.analyzer import search as search_k3
    from cruise_control_tpu_torch.analyzer.search import ExclusionMasks
    flush64 = torch.zeros(32 << 20, dtype=torch.float64, device=dev)
    for name, entry, dests in (("1k_100k_cap", "1k_100k", 250),
                               ("7k_1m_cap", "7k_1m", 512)):
        state, meta = build_fixture(refs[entry], dev)
        goals = k6_goals("default", state.num_brokers)
        active = [g.name for g in goals].index("ReplicaDistributionGoal")
        calls = []
        orig = search_k3.select_batch

        def rec(*a, **kw):
            calls.append((a, kw))
            return orig(*a, **kw)

        search_k3.select_batch = rec
        try:
            chain_k3._chain_round_body(
                state, agg_k3.compute_agg(state, meta.num_topics), active,
                [j < active for j in range(len(goals))], goals,
                BalancingConstraint(),
                SearchConfig(num_sources=2048, num_dests=dests,
                             moves_per_round=2048),
                meta.num_topics, ExclusionMasks())
        finally:
            search_k3.select_batch = orig
        a, kw = calls[0]
        (r0, c0), (r1, c1) = a[3]

        def k3():
            return search_k3.select_batch(*a, **kw)

        def k3_cold():
            flush64.add_(1.0)
            return k3()

        for tag, fn in (("", k3), ("_cold", k3_cold)):
            out[f"k3{tag}_{name}"] = dict(
                rows=r0 * c0 + r1 * c1, layout=[[r0, c0], [r1, c1]],
                m=min(a[4], r0 + r1), **device_ops(fn))
        del calls, a, kw, state
    print(json.dumps(out))
    sys.exit(0)
if MODE == "k3r":
    import inspect
    from cruise_control_tpu_torch.analyzer import agg as agg_r
    from cruise_control_tpu_torch.analyzer import chain as chain_r
    from cruise_control_tpu_torch.analyzer import search as search_r
    from cruise_control_tpu_torch.analyzer.search import ExclusionMasks
    flush64 = torch.zeros(32 << 20, dtype=torch.float64, device=dev)
    fused = "live" in inspect.signature(
        search_r.cumulative_select).parameters
    live = torch.ones((), dtype=torch.bool, device=dev)
    for name, entry, srcs, dests, moves in (
            ("100_10k", None, 256, 32, 64),
            ("1k_100k_cap", "1k_100k", 2048, 250, 2048),
            ("7k_1m_cap", "7k_1m", 2048, 512, 2048)):
        state, meta = build_fixture(refs[entry], dev) if entry else \
            random_cluster(100, 10, 10_000, rf=3, num_racks=8, seed=42,
                           skew_to_first=2.0, target_utilization=0.55,
                           dist=Dist.EXPONENTIAL, device=dev)
        goals = k6_goals("default", state.num_brokers)
        active = [g.name for g in goals].index("ReplicaDistributionGoal")
        calls = []
        orig = chain_r.cumulative_select

        def rec(*a, **kw):
            calls.append((a, kw))
            return orig(*a, **kw)

        chain_r.cumulative_select = rec
        try:
            chain_r._chain_round_body(
                state, agg_r.compute_agg(state, meta.num_topics), active,
                [j < active for j in range(len(goals))], goals,
                BalancingConstraint(),
                SearchConfig(num_sources=srcs, num_dests=dests,
                             moves_per_round=moves),
                meta.num_topics, ExclusionMasks())
        finally:
            chain_r.cumulative_select = orig
        a, kw = calls[0]
        (r0, c0), (r1, c1) = a[3]

        def select(a=a, kw=kw):
            if fused:
                return search_r.cumulative_select(*a, **dict(kw, live=live))
            return search_r.cumulative_select(*a, **kw)[1] & live

        def select_cold(fn=select):
            flush64.add_(1.0)
            return fn()

        for tag, fn in (("", select), ("_cold", select_cold)):
            out[f"k3r{tag}_{name}"] = dict(
                rows=r0 + r1, m=min(a[4], r0 + r1), fused=fused,
                **device_ops(fn))
        del calls, a, kw, state
    print(json.dumps(out))
    sys.exit(0)
if MODE == "kd3":
    import numpy as np
    from cruise_control_tpu_torch.analyzer import direct as direct_p
    from cruise_control_tpu_torch.analyzer import direct_kernels as dk_p
    from cruise_control_tpu_torch.analyzer.search import ExclusionMasks
    flush64 = torch.zeros(32 << 20, dtype=torch.float64, device=dev)
    cases = []
    for entry in ("1k_100k", "7k_1m"):
        state, meta = build_fixture(refs[entry], dev)
        goals = k6_goals("default", state.num_brokers)
        index = [g.name for g in goals].index("TopicReplicaDistributionGoal")
        plans = []
        orig_plan = direct_p.direct_plan

        def rec_plan(*a, **kw):
            if not plans:
                plans.append(([x.clone() if isinstance(x, torch.Tensor)
                               else x for x in a], dict(kw)))
            return orig_plan(*a, **kw)

        direct_p.direct_plan = rec_plan
        try:
            direct_p._direct_sweep(state, goals, index, BalancingConstraint(),
                                   meta.num_topics, ExclusionMasks())
        finally:
            direct_p.direct_plan = orig_plan
        torch.cuda.synchronize()
        cases.append((f"{entry}_topic_plane", plans[0]))
        del state
    rng = np.random.default_rng(0)
    for b in (1000, 7000):
        cnt = rng.poisson(30.0, (1, b)).astype(np.float32)
        cnt[:, rng.random(b) < 0.1] //= 3
        avg = cnt.mean(axis=1, keepdims=True)
        alive = torch.as_tensor(rng.random(b) > 0.05, device=dev)
        cases.append((f"g1_{b}", ([
            torch.as_tensor(cnt, device=dev),
            torch.as_tensor(np.floor(avg / 1.1).astype(np.float32),
                            device=dev),
            torch.as_tensor(np.ceil(avg * 1.1).astype(np.float32),
                            device=dev),
            alive, alive & torch.as_tensor(rng.random(b) > 0.05,
                                           device=dev)], {})))
    for name, (a, kw) in cases:
        def plan(a=a, kw=kw):
            return dk_p.direct_plan(*a, **kw)

        for tag, fn in (("", plan), ("_cold", lambda f=plan: (
                flush64.add_(1.0), f()))):
            out[f"kd3{tag}_{name}"] = dict(shape=list(a[0].shape),
                                           **device_ops(fn))
    print(json.dumps(out))
    sys.exit(0)
if MODE == "k5":
    from cruise_control_tpu_torch.analyzer.goals.intra_broker import (
        IntraBrokerDiskUsageDistributionGoal)
    from cruise_control_tpu_torch.testing import random_placement_disks
    flush64 = torch.zeros(32 << 20, dtype=torch.float64, device=dev)
    band = IntraBrokerDiskUsageDistributionGoal()._band()
    # K5's own device ops (its kernels, the memset of its counts and the
    # copy of the input disks), summed apart from the wrapper's PyTorch ops.
    K5_OPS = ("count_kernel", "scan_kernel", "scatter_kernel",
              "split_kernel", "balance_kernel", "fixup_kernel", "Memset (",
              "Memcpy DtoD")
    jb_state, _m = build_fixture(refs["7k_1m_rebalance_disk"], dev)
    jb = cluster_to_numpy(jb_state)
    cases = [(entry.replace("7k_1m_", "7k_1m_d2_"), jb_state,
              disks_mod.disks_from_numpy(entry_disks(refs[entry], jb), dev),
              b_, None)
             for entry, b_ in (("7k_1m_rebalance_disk", band),
                               ("7k_1m_remove_disks", None))]
    rp_state, _m = build_fixture(refs["1k_100k"], dev)
    rp = cluster_to_numpy(rp_state)
    for num_disks, b_, seed in ((4, band, 4), (8, None, 8)):
        dk, mv = random_placement_disks(rp["assignment"],
                                        rp["partition_mask"],
                                        rp["capacity"][:, 3], num_disks, seed)
        cases.append((f"1k_100k_d{num_disks}_random_placement", rp_state,
                      disks_mod.disks_from_numpy(dk, dev), b_,
                      torch.as_tensor(mv, device=dev)))
    for name, st, dk, b_, mv in cases:
        def k5(st=st, dk=dk, b_=b_, mv=mv):
            return disks_mod.balance_intra_broker(st, dk, 0.8, b_, 64, mv)

        k5()
        rounds = disks_mod.LAST_CALL["rounds"].cpu()
        info = dict(rounds_max=int(rounds.max()),
                    brokers_above_8_rounds=int((rounds > 8).sum()),
                    largest_broker=disks_mod.LAST_CALL[
                        "max_replicas_per_broker"])
        for tag, fn in (("", k5), ("_cold", lambda f=k5: (
                flush64.add_(1.0), f()))):
            got = device_ops(fn)
            got["k5_ms"] = sum(v for k, v in got["kernels"].items()
                               if any(n in k for n in K5_OPS))
            out[f"k5{tag}_{name}"] = dict(**info, **got)
    print(json.dumps(out))
    sys.exit(0)
if MODE == "kd4":
    from cruise_control_tpu_torch.analyzer import direct as direct_f
    from cruise_control_tpu_torch.analyzer import fill as fill_f
    from cruise_control_tpu_torch.analyzer.search import ExclusionMasks
    flush64 = torch.zeros(32 << 20, dtype=torch.float64, device=dev)
    for entry in ("1k_100k", "7k_1m"):
        state, meta = build_fixture(refs[entry], dev)
        goals = k6_goals("default", state.num_brokers)
        index = [g.name for g in goals].index("TopicReplicaDistributionGoal")
        calls = []
        orig_fill = direct_f.direct_fill_dests

        def rec_fill(*a):
            if not calls:
                calls.append([x.clone() for x in a])
            return orig_fill(*a)

        direct_f.direct_fill_dests = rec_fill
        try:
            direct_f._direct_sweep(state, goals, index, BalancingConstraint(),
                                   meta.num_topics, ExclusionMasks())
        finally:
            direct_f.direct_fill_dests = orig_fill
        torch.cuda.synchronize()
        group, rank, cum_d, cum_h = calls[0]
        del state

        def fill(a=calls[0]):
            return fill_f.direct_fill_dests(*a)

        info = dict(n=int(group.numel()), shape=list(cum_d.shape))
        for tag, fn in (("", fill), ("_cold", lambda f=fill: (
                flush64.add_(1.0), f()))):
            out[f"kd4{tag}_{entry}"] = dict(**info, **device_ops(fn))
        # The yardstick: one torch.searchsorted over the rows laid end to
        # end (each offset past the last), never called by the port.
        span = float(cum_d.max()) + 2.0
        rows = torch.arange(cum_d.shape[0], device=dev)
        flat = (cum_d + rows[:, None] * span).reshape(-1)
        q = rank + 0.5 + group * span
        out[f"kd4_library_{entry}"] = dict(**info, **device_ops(
            lambda: torch.searchsorted(flat, q, right=True)))
    print(json.dumps(out))
    sys.exit(0)
if MODE in ("k2l", "k8"):
    from cruise_control_tpu_torch.analyzer import agg as agg_s
    from cruise_control_tpu_torch.analyzer import candidates as cand_s
    from cruise_control_tpu_torch.analyzer import chain as chain_s
    from cruise_control_tpu_torch.analyzer import search as search_s
    from cruise_control_tpu_torch.analyzer.search import ExclusionMasks
    from cruise_control_tpu_torch.testing import k2_round_inputs
    flush64 = torch.zeros(32 << 20, dtype=torch.float64, device=dev)

    def swap_args(state, num_topics, chain, goal):
        # K8's arguments in one eager swap round of ``goal``
        # (testing.k8_round_inputs, written out: an older checkout timed
        # here may lack it).
        goals = k6_goals(chain, state.num_brokers)
        active = [g.name for g in goals].index(goal)
        rec = []
        orig = search_s.swap_top_replicas

        def record(*a):
            rec.append(a)
            return orig(*a)

        search_s.swap_top_replicas = record
        try:
            chain_s._chain_swap_body(
                state, agg_s.compute_agg(state, num_topics), active,
                [j < active for j in range(len(goals))], goals,
                BalancingConstraint(), num_topics, ExclusionMasks())
        finally:
            search_s.swap_top_replicas = orig
        return rec[0]

    cases = []
    for entry in ("1k_100k", "7k_1m"):
        state, meta = build_fixture(refs[entry], dev)
        if MODE == "k2l":
            if entry == "7k_1m":
                state = set_broker_state(state, torch.arange(6950, 7000), 1)
            score, weight = k2_round_inputs(state, meta.num_topics)
            name = "1k_100k_cap" if entry == "1k_100k" else "7k_1m_dead50"
            cases.append((name, lambda s=state, c=score, w=weight:
                          cand_s.leadership_sources(s, c, w, 2048),
                          dict(k=2048)))
            continue
        for chain, goal in (("default", "DiskUsageDistributionGoal"),
                            ("kafka", "KafkaAssignerDiskUsageDistributionGoal")):
            if chain == "kafka" and entry != "1k_100k":
                continue
            a = swap_args(state, meta.num_topics, chain, goal)
            name = f"{entry}_{'kafka_assigner' if chain == 'kafka' else 'first_swap'}"
            cases.append((name, lambda a=a: search_s.swap_top_replicas(*a),
                          dict(k=int(a[2].shape[0]), j=int(a[4]))))
    for name, fn, info in cases:
        def cold(fn=fn):
            flush64.add_(1.0)
            return fn()

        for tag, f in (("", fn), ("_cold", cold)):
            out[f"{MODE}{tag}_{name}"] = dict(**info, **device_ops(f))
    print(json.dumps(out))
    sys.exit(0)
if MODE in ("kd1", "kd2"):
    import dataclasses
    from cruise_control_tpu_torch.analyzer import direct as direct_d
    from cruise_control_tpu_torch.analyzer import direct_kernels as dk_d
    from cruise_control_tpu_torch.analyzer.search import ExclusionMasks
    from cruise_control_tpu_torch.utils.numerics import total_order_key
    flush64 = torch.zeros(32 << 20, dtype=torch.float64, device=dev)

    def snap(x, memo=None):
        # Cloned once a tensor, so the copy keeps the call's aliasing (KD2
        # judges checks that share a table as one).
        memo = {} if memo is None else memo
        if isinstance(x, torch.Tensor):
            if id(x) not in memo:
                memo[id(x)] = x.clone()
            return memo[id(x)]
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: snap(getattr(x, f.name), memo)
                for f in dataclasses.fields(x)})
        if isinstance(x, (list, tuple)):
            return type(x)(snap(v, memo) for v in x)
        return x

    def library(kind, a):
        if kind == "kd1":
            key, second = a[0], a[2] if len(a) > 2 else None
            if second is None:
                return lambda: torch.sort(key, stable=True)
            comp = key.long() * 2 ** 32 + total_order_key(
                dk_d.sort_order_second(second)).long() + 2 ** 31
            return lambda: torch.sort(comp, stable=True)
        flat = a[1].t().contiguous().reshape(-1)
        return lambda: torch.cumsum(flat, 0)

    for entry in ("1k_100k", "7k_1m"):
        state, meta = build_fixture(refs[entry], dev)
        goals = k6_goals("default", state.num_brokers)
        index = [g.name for g in goals].index("TopicReplicaDistributionGoal")
        calls = {}
        orig_sort, orig_scan = direct_d.sort_pairs, direct_d.segment_scan

        def rec_sort(*a, **kw):
            mover = len(a) > 2 and a[2] is not None
            calls.setdefault(("kd1", "mover_sort" if mover
                              else "keyed_sort"), snap((a, kw)))
            return orig_sort(*a, **kw)

        def rec_scan(*a, **kw):
            if len(a) > 2 and a[2] and a[1].dim() == 2:
                calls.setdefault(("kd2", "load_guards"), snap((a, kw)))
            return orig_scan(*a, **kw)

        direct_d.sort_pairs, direct_d.segment_scan = rec_sort, rec_scan
        try:
            direct_d._direct_sweep(state, goals, index, BalancingConstraint(),
                                   meta.num_topics, ExclusionMasks())
        finally:
            direct_d.sort_pairs, direct_d.segment_scan = orig_sort, orig_scan
        torch.cuda.synchronize()
        for (kind, what), (a, kw) in sorted(calls.items()):
            if kind != MODE:
                continue
            fn = (dk_d.sort_pairs if kind == "kd1" else dk_d.segment_scan)
            info = dict(n=int(a[0].numel()),
                        values=int(a[1].numel()) if kind == "kd2" else None)

            def call(fn=fn, a=a, kw=kw):
                return fn(*a, **kw)

            for tag, f in (("", call), ("_cold", lambda c=call: (
                    flush64.add_(1.0), c()))):
                out[f"{kind}{tag}_{entry}_{what}"] = dict(
                    **info, **device_ops(f))
            lib = library(kind, a)
            out[f"{kind}_library_{entry}_{what}"] = dict(
                **info, **device_ops(lib))
        del calls, state
    print(json.dumps(out))
    sys.exit(0)
big, big_meta = random_cluster(7000, 700, 1_000_000, rf=3, num_racks=8,
                               seed=42, skew_to_first=2.0,
                               target_utilization=0.55,
                               dist=Dist.EXPONENTIAL, device=dev)
big = set_broker_state(big, torch.arange(6950, 7000), 1)
topics = big_meta.num_topics
derived = compute_derived(big)
flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)


def cold(fn):
    def run():
        flush.add_(1)
        return fn()
    return run


for family, (name, kwargs) in FAMILY_GOALS.items():
    goal = ALL_GOALS[name](**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in kwargs.items()})
    aux = goal_aux(goal, big, derived, BalancingConstraint(), topics)
    override = not goal.leadership_only

    def k7():
        return slot_pass.slot_weights(goal, big, derived,
                                      BalancingConstraint(), aux, topics,
                                      override)

    def offline_work():
        if len(k7()) == 3:
            agg_mod.offline_per_broker(big)

    for tag, wrap in (("", lambda fn: fn), ("_cold", cold)):
        out[f"k7{tag}_7k_1m_dead50_{family}"] = dict(
            goal=name, override=override, **device_ms(wrap(k7)))
        if family in OFFLINE_WORK:
            out[f"offline_work{tag}_7k_1m_dead50_{family}"] = dict(
                goal=name, **device_ms(wrap(offline_work)))
    del aux
del big, derived, flush
if K7_ONLY:
    print(json.dumps(out))
    sys.exit(0)
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
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--k7-only", action="store_true")
    only.add_argument("--k3-only", action="store_true")
    only.add_argument("--k2l-only", action="store_true")
    only.add_argument("--k8-only", action="store_true")
    only.add_argument("--kd1-only", action="store_true")
    only.add_argument("--kd2-only", action="store_true")
    only.add_argument("--kd3-only", action="store_true")
    only.add_argument("--k3r-only", action="store_true")
    only.add_argument("--k5-only", action="store_true")
    only.add_argument("--kd4-only", action="store_true")
    args = ap.parse_args()
    from . import K7_FAMILY_GOALS, k7_family_goal_args
    families = {f: k7_family_goal_args(f, 7000) for f in K7_FAMILY_GOALS}
    child_args = [json.dumps(families),
                  "k7" if args.k7_only else "k3" if args.k3_only
                  else "k2l" if args.k2l_only else "k8" if args.k8_only
                  else "kd1" if args.kd1_only else "kd2" if args.kd2_only
                  else "kd3" if args.kd3_only else "k3r" if args.k3r_only
                  else "k5" if args.k5_only else "kd4" if args.kd4_only
                  else "all"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for turn in range(args.turns):
        for root in args.roots if turn % 2 == 0 else args.roots[::-1]:
            res = subprocess.run([sys.executable, "-c", _CHILD,
                                  *child_args], cwd=root,
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
