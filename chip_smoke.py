#!/usr/bin/env python3
"""Drive the PyTorch port (cruise_control_tpu_torch) once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an error; each
prints its wall). Every solve runs the round loop as CUDA graphs of
``chain.ROUNDS_PER_BLOCK`` rounds: the first solve of a shape captures
them (its capture seconds printed), a steady solve must capture nothing,
and each solve prints its replays, host reads (one per dispatch, the
freeze-flag polls, the goal statistics) and frozen rounds. Kernel
launches are counted per replay of each graph.

1. Print the card's name and power limit, build the thirteen CUDA kernel
   libraries (one nvcc per source, all started together) and print the
   build time and each kernel's registers, stack and spills from
   ``ptxas -v`` (and K3's shared memory a CTA at its cap).
2. Fused path, 100 brokers / 10k partitions / RF 3 / 8 racks
   (``_run_stage``): a warm-up solve (the capture) recording the real
   inputs of the kernels of its rounds (the eager round before each
   capture; a call made while a graph captures holds no values); each
   kernel held against its plain PyTorch twin on those inputs (K1 and K4
   bit for bit against the twin run on a CPU copy, which sums in the
   reference's index order; K2 exact; K3 exact on idx/part_ok/has_earlier
   and bitwise on every f32 field it writes (the selected rows, the
   pre-deltas, pot and lbi), its final sel (the joint recheck and the
   move cap, in its select kernel since K6's recheck mode was folded in)
   exactly against part_ok, the recheck's twin and the cap, at most 3
   device ops a call with its wrapper's, on the first round's inputs and
   on the first round of every goal that ran one; K6's grid mode bitwise
   against the twin on the card likewise; K7 bitwise against its twin on every goal's
   first move round and first swap round: weight, offline mask and flag,
   and the offline count per broker, which is also held exactly to K1's
   offline twin on a CPU copy (zeros without the override); K2's
   leadership mode and K8 exact on their first calls) and timed with
   CUDA events and the profiler beside the twin, its bound and, where one
   exists, a single PyTorch library call.
3. Fused main path: launch counts reset, one steady solve, counts read;
   every hard goal satisfied, balancedness rose, proposals exist, every
   kernel of the round launched (on this and every later main path K7
   once per move round and per swap round, K2's leadership mode once per
   move round, K3 once per move round, K8 once per swap round as
   ``last_loop_stats()`` counts them, and K1's offline mode and K6's
   recheck mode never: K7 counts the round's offline replicas, K3
   rechecks). A profiled solve gives the
   device-busy share.
4. Fused reference on a small input: 16/512 on the card and on the CPU
   (which the CPU tests hold bit-exact against the JAX package) must agree
   on the violated goals, balancedness, assignment and proposals.
5. Bounded path, 1,000 brokers / 100k partitions, default config with
   ``solver.dispatch.target.seconds=0``: a warm-up solve (the capture)
   recording the kernels' inputs (among them a deficit-sized round at m =
   2,048 over 2,048 move and 2,048 leadership rows), then the main path:
   launch counts reset, one steady solve, counts read, every kernel
   launched. Every hard goal satisfied and the violated sets,
   balancedness, proposal count and violation fingerprint equal to the
   JAX package's CPU outcome carried in
   ``cruise_control_tpu_torch/testing/reference_outcomes.json`` (K6 held
   and K3 held to their twins on every goal's first round of the
   warm-up); whether
   the assignment and leader digests and the dispatch statistics equal
   the reference's, and the first goal whose moves differ, are printed.
   The steady solve's ``stats_before`` and ``stats_after`` must equal
   ``cluster_stats`` run on the CPU on copies of the same states, bit for
   bit. Then the async pump's speculative dispatches are costed: one solve
   with every dispatch timed, and one with
   ``solver.dispatch.async.readback=false`` (no speculative dispatch),
   each held to the same reference.
6. The same fixture with its last 50 brokers DEAD, against its entry: a
   warm-up solve (its first move round's K7 call held to the twin, its
   count to K1's offline twin with offline replicas present; that state
   is K1's offline mode's direct input in phase 8; K3 held to its twin on
   its first round), then a steady solve
   as a main path of its own (launch counts reset and read).
7. The same fixture with the default config (wall-clock adaptive
   dispatch): a warm-up solve (its budgets reach the 64-round aggregate
   refresh, so it captures each goal's refresh variant), a second solve,
   which must capture nothing, whose TopicReplicaDistributionGoal pass
   runs under the profiler (the device-busy share of that pass, and K4's
   and K1's shares of its device time), then a steady solve: wall,
   rounds, dispatches, launches per kernel. Every hard goal satisfied and the violated sets, balancedness
   and violation fingerprint equal to the healthy reference; the proposal
   count and the digest comparison are printed.
8. The kernels at the bounded path's shapes, from phase 5's recorded
   inputs: K3 at its cap (with its recheck at m = 2,048), K6 on the wide
   grid (2,048 source rows), K7 on the first round, K2's leadership mode
   at its cap (k = 2,048) and on drain-50's first call, K8 on the first
   swap round and on crafted tie cases, K4 at m = 2,048 and on an
   adversarial batch (every row leaving broker 0 within topic 0, every
   4th row unselected and naming broker B-1), K1 and K2 at 1k/100k
   (K1's offline mode and K2 also on phase 6's first recorded calls:
   4,971 offline replicas, each weighing 1e30 in K2's input), each
   against its twin as in phase 2, and timed (K2's leadership mode and K8,
   one cooperative launch each, fail above two device ops a timed call).
9. K1 (full and offline), K2 and K4 at 7,000 brokers / 1M partitions /
   700 topics with the last 50 brokers DEAD: K1 and K4 bitwise against
   their twins on a CPU copy (K4 on 2,048 replicas of the DEAD brokers
   moved to seeded live brokers, every 8th row unselected), K2 exact on
   DiskUsageDistributionGoal's scores and weights as the round body
   builds them (the offline count added to the score, 6,830 offline
   replicas at 1e30) and without that override, K2's leadership mode on
   the same inputs; timed; K8 exact on crafted tie cases. K1's offline
   check fails on an input without offline replicas (an all-zero twin
   output). K7 on one goal of each weight family
   (``testing.K7_FAMILY_GOALS``), bitwise against its twin, its count
   exact (offline replicas present), timed beside its bound.
10. The bounded solve at 7,000 brokers / 1M partitions / 700 topics
    (``bench.py``'s STAGES (7_000, 1_000_000, 0), the targeted column
    off), pinned dispatch: a warm-up solve (the capture) and a steady
    solve (launch counts reset and read, every kernel launched), each held
    to the ``7k_1m`` reference entry as in phase 5; the digests printed.
    K3 at its cap (m = 2,048, with the recheck) and K6 on its
    2,048-source grid, recorded from the warm-up, with the targeted column
    off, held against their twins as in phase 8 and timed; K3, K6 and K7
    also on every goal's first round of the warm-up; K7 and K8 timed on the
    first move and swap round; one move round and one swap round of the
    warm-up rerun eagerly under the profiler, which must show no sort or
    top-k over P*S keys.
    The swap round's grid at 1M (``search.swap_grid``, its top-j by K8)
    timed with CUDA events and by its device time, beside the twin of its
    top-j (two stable sorts over [8, P*S] keys).
11. The JBOD disk path at 7k/1M (the ``7k_1m`` fixture with two log
    dirs a broker, ``testing.entry_disks``): ``rebalance_disk``
    (IntraBrokerDiskUsageDistributionGoal) and ``remove_disks`` (dir 1
    of brokers 6,950-6,999 dead, IntraBrokerDiskCapacityGoal), each a
    warm-up call, then a main path of its own (launch counts reset and
    read: K5's balancer and its load mode): violations, optimize,
    violations, held to the ``7k_1m_rebalance_disk`` /
    ``7k_1m_remove_disks`` entries (the final disk assignment's digest,
    moves, the violations' bits and sums, replicas left on dead dirs).
    K5 against its twin on a CPU copy (disk assignment and final loads
    bit for bit) on both calls, at D = 4 and 8 on seeded random
    placements at 1k/100k, on the sentinel-collision fixtures, on 40
    small random ones and on K5's edge cases (``testing.k5_edge_case``: a
    broker at exactly 8,192 replicas, 32 dirs, brokers that run all 64
    rounds, an active fix-up); each timed beside the twin on the card and
    its bound, with each call's wall, the rounds of the broker that ran
    most, the brokers above 8 rounds and the brokers without a pick above
    a sentinel slot's owner printed. K5's device launches per call must be the same at every
    shape. K5's load mode (``disk_load``) bit for bit against its twin,
    run under ``torch.cuda.set_sync_debug_mode("error")`` (no host
    synchronisation), on both calls' disks, at D = 4 and 8 at 1k/100k and
    on a broker above the balancer's 8,192 replicas (4 brokers, 12,000
    partitions, D = 2 and 8: the load mode returns its loads, the
    balancer must raise its limit); timed at 7k/1M with D = 2 and at
    1k/100k with D = 4 and 8 beside its twin, one ``index_add_`` of the
    same slots and its bound, four device ops a call at every shape.
12. ``demote_broker``'s solve at 7k/1M: brokers 6,950-6,999 DEMOTED and
    excluded for leadership, PreferredLeaderElectionGoal alone, pinned
    dispatch: a warm-up solve, then a steady solve (launch counts reset
    and read, every chain kernel launched), held to ``7k_1m_demote``
    (its pinned fields, the violation fingerprint and both digests).
13. Kafka-assigner mode at 1k/100k (KafkaAssignerEvenRackAwareGoal,
    KafkaAssignerDiskUsageDistributionGoal), pinned: warm-up, then
    steady, held to ``1k_100k_kafka_assigner``. On phases 12-14 K2's
    leadership mode and K8 are also held to their twins on the warm-up's
    first calls.
14. The 18-goal chain at 100/10k (RackAwareDistributionGoal,
    BrokerSetAwareGoal on config/brokerSets.json,
    MinTopicLeadersPerBrokerGoal, then the default chain), pinned, fused:
    warm-up, then steady, held to ``100_10k_extra_chain``. In 12-14 K3,
    K6 and K7 are held to their twins on every goal's first round of the
    warm-up.
14a. The default chain at 1k/100k with the direct-assignment transport
    on (``1k_100k_direct``: density 3.0, so the replica, topic and
    leader count goals all take it): a warm-up solve recording the
    inputs of KD1-KD4 (the first call of each kernel, goal and variant,
    and each kernel's largest), each held against its twin run on a CPU
    copy (KD1's permutation and keys and KD4's destinations exact, KD2's
    sums and verdicts and KD3's planes bit for bit); one sweep of each
    goal from its recorded entry under
    ``torch.cuda.set_sync_debug_mode("error")``; each kernel timed on its
    largest call, and KD1 also on a position-keyed sort, beside its twin
    on the card, its bound and one PyTorch call (``torch.sort``,
    ``torch.cumsum``, ``torch.searchsorted``; none for KD3), its device
    ops a call held to its limit (KD1 one launch more than its radix
    passes, KD2-KD4 one); then a steady solve, launch counts reset and read (every KD
    kernel and every round kernel launched, nothing captured), held to
    the entry as phase 5 holds its own, each goal's direct moves and
    sweeps included, the digests printed.
14b. The same at 7k/1M (``7k_1m_direct``: density 0.61, so only
    TopicReplicaDistributionGoal takes it), with one sweep of it run
    under the profiler, which must show no PyTorch sort, top-k, cumsum,
    cummax or searchsorted over P*S elements.
14c. KD3 on one row (G = 1, as a cluster-wide count goal plans) at 1,000
    and 7,000 brokers (``testing.kd3_case`` dense counts), bit for bit
    against its twin on a CPU copy and timed as in 14a.
15. K6's grid mode against its twin bitwise, and K3 with the recheck
    against the composition, with every goal of the four
    ``testing.K6_CHAINS`` (all 14 goal families) active that no solve
    above gave a round of: one eager round at 100/10k each; K7 likewise
    on every goal of ``ALL_GOALS`` (all 21) no solve reached, directly
    at 100/10k with 5 brokers DEAD. The goals and where each was held are
    printed.
16. One JSON line describing each kernel, K1's and K5's two modes apart
    (at the bounded path's shapes, with the other shapes under
    ``other_shapes``, and launches per steady solve of every main path;
    KD1-KD4 at 7k/1M with 1k/100k and KD3's G = 1 rows under
    ``other_shapes``; K3's line covers the recheck and the cap,
    ``also_replaces``), then the device line. Every line carries its
    device launches per call from the profiler (K6's grid mode two, or
    the run fails; each K6 line names the active goal of its round); K2's
    lines also the nodes of a CUDA graph capturing one call, which must
    be the same at every shape, or the run fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time

SIZE = dict(num_brokers=100, num_topics=10, num_partitions=10_000, rf=3,
            num_racks=8, seed=42, skew_to_first=2.0, target_utilization=0.55)
SMALL = dict(num_brokers=16, num_topics=8, num_partitions=512, rf=3,
             num_racks=8, seed=42, skew_to_first=2.0, target_utilization=0.55)
BIG = dict(num_brokers=7000, num_topics=700, num_partitions=1_000_000, rf=3,
           num_racks=8, seed=42, skew_to_first=2.0, target_utilization=0.55)
# The goal whose pass phase 7 profiles, and the largest K3 / K4 grid.
PROFILED_GOAL = "TopicReplicaDistributionGoal"
CAP_ROWS, CAP_M = 4096, 2048
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
REPS = 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _dev_us(evt, self_only: bool) -> float:
    """Device microseconds of a profiler average (attribute names moved
    between PyTorch releases)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profiled_calls(fn, reps: int):
    """The profiler's per-op averages over ``reps`` calls of ``fn`` after
    one skipped and two warm-up steps (a trace started without them loses
    the events of its first calls once the process has traced before)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=2, active=reps)) as prof:
        for _ in range(3 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof.key_averages()


def device_ms(fn, kernel_names, reps: int = REPS):
    """(device time per call of the named CUDA kernels, their device
    launches per call), from a torch.profiler trace of ``reps`` calls
    after one skipped and two warm-up steps (a trace started without them
    loses the events of its first calls once the process has traced
    before); the time is None when the trace shows no device time (then
    only the CUDA-event time stands).

    A trace taken late in a long process can still lose device records
    (the host's ``cudaMemsetAsync`` 20 times, its device memset 17), so
    each op is counted ``round(records / reps)`` times a call (at least
    once) and timed at its mean per record: exact when nothing was lost,
    and not biased low by what was. A loss is printed; a trace with no
    record of the named ops gives (None, None). The loss grows with the
    process's life, whatever the idle time at the window's edges (10 of
    10 records of a one-kernel call kept at the start, 9, 7, 5, 3, 1 and
    0 in every other trace after each further ~30 s of solves, on the
    H100)."""
    mine = [e for e in profiled_calls(fn, reps) if e.count
            and any(n in e.key for n in kernel_names)]
    if not mine:
        print(f"  profiler trace of {reps} calls holds no record of "
              f"{kernel_names}: device time and ops not measured")
        return None, None
    per_call = {e.key: max(1, round(e.count / reps)) for e in mine}
    total = sum(_dev_us(e, False) / e.count * per_call[e.key] for e in mine)
    records = sum(e.count for e in mine)
    if records != reps * sum(per_call.values()):
        print(f"  profiler trace of {reps} calls holds {records} records "
              f"of the named ops, not {reps * sum(per_call.values())} "
              "(timed per record)")
    return (total / 1e3 if total > 0 else None, sum(per_call.values()))


def held_stream_ms(fn, reps: int = REPS) -> float:
    """Device ms a call of ``fn``, without the profiler: the median gap
    between CUDA events recorded around each of ``reps`` calls queued
    behind a sleeping kernel, so the device runs them back to back
    whatever the host's pace (the gap includes the device's own turn
    between two kernels)."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)      # ~50 ms of the H100's clock
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    gaps = sorted(events[i].elapsed_time(events[i + 1]) for i in range(reps))
    return gaps[reps // 2]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_solve(opt, state, meta, goals, steady_s: float) -> dict:
    """One more solve under torch.profiler (not the measured one): the
    device-busy share of its wall and the ops that take the device time
    (the kernels of replayed CUDA graphs among them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        opt.optimizations(state, meta, goals=goals)
        torch.cuda.synchronize()
        wall = time.time() - t0
    # Device-side events only: the CPU ops carry their kernels' time too.
    avgs = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(_dev_us(e, True) for e in avgs) / 1e6
    launches = sum(e.count for e in avgs)
    top = sorted(avgs, key=lambda e: _dev_us(e, True), reverse=True)[:8]
    print(f"profile: profiled solve {wall:.3f} s (steady unprofiled "
          f"{steady_s:.3f} s), device busy {busy:.3f} s = "
          f"{busy / wall:.1%} of the profiled wall, {launches} device ops")
    for e in top:
        print(f"  device {_dev_us(e, True) / 1e3:9.2f} ms  calls {e.count:6d}"
              f"  {e.key[:90]}")
    return dict(wall_s=wall, busy_s=busy, busy_share=busy / wall,
                device_ops=launches)


def to_cpu(obj):
    """A tensor, or a dataclass, namespace or sequence of tensors, copied
    to the host; anything else as it is."""
    import dataclasses
    import types

    import torch
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: to_cpu(getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: to_cpu(v)
                                        for k, v in vars(obj).items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    return obj.cpu() if isinstance(obj, torch.Tensor) else obj


def snapshot(obj, _memo=None):
    """A recorded argument with every tensor in it cloned: a round's
    inputs may be the round loop's static buffers, which later replays
    overwrite. A tensor met twice is cloned once, so the copy keeps the
    call's aliasing (KD2 judges checks that share a table as one)."""
    import dataclasses
    import types

    import torch
    memo = {} if _memo is None else _memo

    def again(x):
        return snapshot(x, memo)

    if isinstance(obj, torch.Tensor):
        if id(obj) not in memo:
            memo[id(obj)] = obj.clone()
        return memo[id(obj)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: again(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: again(v)
                                        for k, v in vars(obj).items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(again(x) for x in obj)
    if isinstance(obj, dict):
        return {k: again(v) for k, v in obj.items()}
    return obj


class Recorder:
    """Wraps the kernel wrappers the chain calls and keeps copies of the
    inputs of the first call of each, of the first call that ``wanted``
    (kernel name -> predicate over the call's arguments) picks out and,
    for K6's two modes, of the first call of each active goal."""

    # The kernels every move round launches (checked on every path).
    KEYS = ("segment_reduce", "select_sources",
            "select_batch", "apply_deltas", "score_grid", "slot_weights",
            "select_leadership")
    K6_KEYS = ("score_grid",)
    # K8 runs in swap rounds only.
    SWAP_KEY = "swap_top_replicas"
    # The round bodies themselves (their first eager call).
    BODY_KEYS = ("_chain_round_body", "_chain_swap_body")

    def __init__(self, chain_mod, search_mod, wanted=None):
        from cruise_control_tpu_torch.analyzer import candidates as cand_mod
        self.calls = {key: [] for key in self.KEYS + (self.SWAP_KEY,)
                      + self.BODY_KEYS}
        self.picked = {}
        # (kernel name, active goal's name) -> the call's arguments.
        self.per_goal = {}
        self._wanted = wanted or {}
        self._patches = []
        self._wrap(chain_mod, "compute_agg", "segment_reduce")
        self._wrap(chain_mod, "select_sources", "select_sources")
        self._wrap(search_mod, "select_batch", "select_batch")
        self._wrap(chain_mod, "apply_deltas_to_agg", "apply_deltas")
        self._wrap(chain_mod, "score_grid", "score_grid")
        self._wrap(chain_mod, "slot_weights", "slot_weights")
        self._wrap(cand_mod, "leadership_sources", "select_leadership")
        self._wrap(search_mod, "swap_top_replicas", "swap_top_replicas")
        for key in self.BODY_KEYS:
            self._wrap(chain_mod, key, key)

    def _wrap(self, mod, attr, key):
        import torch
        orig = getattr(mod, attr)
        calls = self.calls[key]
        want = self._wanted.get(key)

        def wrapper(*args, **kwargs):
            # A call made while a CUDA graph captures runs nothing: its
            # inputs hold no values yet. The eager round before each
            # capture gives every kernel real inputs.
            if torch.cuda.is_current_stream_capturing():
                return orig(*args, **kwargs)
            if not calls:
                calls.append((snapshot(args), snapshot(kwargs)))
            if want is not None and key not in self.picked \
                    and want(*args, **kwargs):
                self.picked[key] = (snapshot(args), snapshot(kwargs))
            if key in self.K6_KEYS:
                # score_grid(state, derived, constraint, goals, aux_list,
                # active, ...)
                goal_key = (key, args[3][args[5]].name)
                if goal_key not in self.per_goal:
                    self.per_goal[goal_key] = snapshot(args)
            if key == "select_batch":
                # select_batch(..., extra_last_col, tail): the tail's joint
                # recheck names the round's goals and the active one
                joint = args[6].recheck
                goal_key = (key, joint.goals[joint.active].name)
                if goal_key not in self.per_goal:
                    self.per_goal[goal_key] = snapshot((args, kwargs))
            if key == "slot_weights":
                # slot_weights(goal, state, derived, constraint, aux,
                # num_topics, override)
                goal_key = (key, args[0].name, args[6])
                if goal_key not in self.per_goal:
                    self.per_goal[goal_key] = snapshot(args)
            return orig(*args, **kwargs)

        self._patches.append((mod, attr, orig))
        setattr(mod, attr, wrapper)

    def restore(self):
        for mod, attr, orig in self._patches:
            setattr(mod, attr, orig)

    def k7_calls(self) -> dict:
        """{(goal's name, override): args} of the first K7 call of each
        goal with and without the offline override."""
        return {key[1:]: args for key, args in self.per_goal.items()
                if key[0] == "slot_weights"}

    def k6_rounds(self) -> dict:
        """{active goal's name: {"grid": args}} of K6's first call in each
        goal's rounds."""
        return {rest[0]: {"grid": args}
                for (key, *rest), args in self.per_goal.items()
                if key in self.K6_KEYS}

    def k3_rounds(self) -> dict:
        """{active goal's name: (args, kwargs)} of K3's first call, with
        its recheck, in each goal's rounds."""
        return {rest[0]: call
                for (key, *rest), call in self.per_goal.items()
                if key == "select_batch"}


def measure(fn, plain_fn, kernel_names, nbytes, ops, library_fn=None,
            reps: int = REPS) -> dict:
    """CUDA-event and profiler times of a kernel's wrapper, its twin's
    time, its bound and the library yardstick's time. Where the profiler
    kept no record of the kernel, its device time is ``held_stream_ms``'s
    and its device ops a call are null (``device_ms_by`` says which)."""
    bms, bby = bound(nbytes, ops)
    dev_ms, dev_launches = device_ms(fn, kernel_names, reps)
    dev_by = "profiler"
    if dev_ms is None:
        dev_ms, dev_by = held_stream_ms(fn, reps), "events, stream held"
    return dict(ms=cuda_ms(fn, reps), device_ms=dev_ms, device_ms_by=dev_by,
                device_launches_per_call=dev_launches,
                plain_ms=cuda_ms(plain_fn, max(3, reps // 4)), bound_ms=bms,
                bound_by=bby,
                library_ms=cuda_ms(library_fn, reps) if library_fn else None)


K1_KERNELS = ["count_kernel", "column_scan_kernel", "base_scan_kernel",
              "place_kernel", "bucket_fold_kernel"]
K1_OFFLINE_KERNELS = ["offline_count_kernel", "to_float_kernel"]
# K2's wrapper zeroes its counters with one memset a call (the device
# event's name, "Memset (<kind>)" for whatever kind the trace gives the
# destination; "cudaMemsetAsync" is the host's).
K2_KERNELS = ["digit_kernel", "seed_kernel", "compact_kernel", "rank_kernel",
              "broker_kernel", "Memset ("]
# K3: the reduce (and the picked fields' records), then the select
# cluster (with the round's joint recheck and move cap in its last phase).
K3_KERNELS = ["reduce_rows_kernel", "select_kernel"]
K4_KERNELS = ["carry_copy_kernel", "event_fold_kernel"]
# K5's kernels (the grouping: the load mode's pass 1 with each slot's flat
# index and the split into each broker's run; a warp a broker's loop with
# its refold from the moved slot; the sentinel fix-up), the memset of the
# largest count and the copy of the input disks: eight device ops a call.
K5_KERNELS = ["load_count_kernel", "load_scan_kernel", "load_scatter_kernel",
              "split_kernel", "balance_kernel", "fixup_kernel", "Memset (",
              "Memcpy DtoD"]
# K5's load mode: bucket count, scan, scatter, fold.
K5L_KERNELS = ["load_count_kernel", "load_scan_kernel",
               "load_scatter_kernel", "load_fold_kernel"]
# K6's grid mode: the destination panel, then the rows.
K6_KERNELS = ["panel_kernel", "score_grid_kernel"]
# K7's kernels and its memsets (the flag, the peak); K2's leadership mode
# and K8, one cooperative launch each (no memset).
K7_KERNELS = ["peak_kernel", "weights_kernel", "Memset ("]
K2L_KERNELS = ["leadership_kernel"]
K8_KERNELS = ["top_replicas_kernel"]
# The most device ops a call of each, its wrapper's own included (K8's
# wrapper joins its two broker lists).
K2L_MAX_OPS = 2
K8_MAX_OPS = 2


def check_k1(agg_mod, state, num_topics, label: str) -> float:
    """K1 full mode bitwise against the twin on a CPU copy; returns the
    largest difference from the twin run on the card."""
    import torch
    host = state.to("cpu")
    out_k = agg_mod.compute_agg(state, num_topics)
    out_p = agg_mod.compute_agg_plain(state, num_topics)
    out_cpu = agg_mod.compute_agg_plain(host, num_topics)
    card_err = 0.0
    for field in ("broker_load", "broker_replicas", "broker_leaders",
                  "pot_nw_out", "lbi", "topic_counts"):
        a = getattr(out_k, field)
        if not torch.equal(a.cpu(), getattr(out_cpu, field)):
            fail(f"K1 {field} at {label}: kernel differs from the "
                 "index-order twin")
        b = getattr(out_p, field)
        if a.dtype.is_floating_point:
            card_err = max(card_err, float((a - b).abs().max()))
        elif not torch.equal(a, b):
            fail(f"K1 {field} at {label}: integer outputs differ from the "
                 "card twin")
    print(f"K1 segment_reduce at {label}: ok (bitwise equal to the twin on "
          f"the CPU; max abs difference {card_err:g} from the twin on the "
          f"card, whose index_add_ sums in atomic order)")
    return card_err


def check_k1_offline(agg_mod, state, label: str) -> None:
    """K1 offline mode bitwise against the twin on a CPU copy, on a state
    with offline replicas: an all-zero twin output would let a kernel
    that writes zeros pass, so it fails the check."""
    import torch
    want = agg_mod.offline_per_broker_plain(state.to("cpu"))
    if not bool((want != 0).any()):
        fail(f"K1 offline check at {label}: the input has no offline "
             "replica, so the twin's output is all zero")
    if not torch.equal(agg_mod.offline_per_broker(state).cpu(), want):
        fail(f"K1 offline mode at {label} differs from its twin")
    print(f"K1 segment_reduce offline at {label}: ok (bitwise equal to the "
          f"twin on the CPU; {int(want.sum())} offline replicas on "
          f"{int((want != 0).sum())} brokers)")


def k1_cost(state, num_topics):
    """(bytes, operations) one full K1 call must move and do."""
    p, s = state.assignment.shape
    b = state.num_brokers
    n_exist = int((state.assignment >= 0).sum())
    nbytes = p * s * 4 + p * (4 + 1 + 16 + 16 + 4) \
        + b * (16 + 4 + 4 + 4 + 4) + num_topics * b * 4
    return nbytes, n_exist * 7


def k1_line(agg_mod, state, num_topics, card_err, label: str) -> dict:
    """K1's full-mode timings at one shape."""
    import torch
    from cruise_control_tpu_torch.model.tensors import broker_segments
    dev = state.device
    p, s = state.assignment.shape
    b = state.num_brokers
    seg = broker_segments(state).reshape(-1)
    stacked = torch.randn(p * s, 8, device=dev)

    def library():
        return torch.zeros(b + 1, 8, device=dev).index_add_(0, seg, stacked)

    nbytes, ops = k1_cost(state, num_topics)
    return dict(shape=label, max_abs_err=0.0, card_twin_max_abs_err=card_err,
                **measure(lambda: agg_mod.compute_agg(state, num_topics),
                          lambda: agg_mod.compute_agg_plain(state,
                                                            num_topics),
                          K1_KERNELS, nbytes, ops, library))


def k1_offline_line(agg_mod, state, label: str) -> dict:
    """K1's offline-mode timings on a state with offline replicas. No
    single PyTorch call computes it (the offline predicate comes first),
    so it has no library yardstick."""
    p, s = state.assignment.shape
    b = state.num_brokers
    return dict(shape=label, max_abs_err=0.0,
                **measure(lambda: agg_mod.offline_per_broker(state),
                          lambda: agg_mod.offline_per_broker_plain(state),
                          K1_OFFLINE_KERNELS, p * s * 4 + p + b * 6, p * s))


def check_k2(candidates_mod, args, label: str) -> dict:
    """K2 exact against its twin; timed beside a partial yardstick,
    ``torch.topk`` of the masked flat weights at ``half``: the global
    block alone, and not in the reference's tie order. Its launches a call
    are the nodes of a CUDA graph that captures one call."""
    import torch

    from cruise_control_tpu_torch.testing import (
        cuda_graph_capture, cuda_graph_nodes,
    )
    got = candidates_mod.select_sources(*args)
    want = candidates_mod.select_sources_plain(*args)
    for name, a, b in zip(("cand_p", "cand_s", "src_valid"), got, want):
        if not torch.equal(a, b):
            fail(f"K2 {name} at {label} differs from its twin")
    state, score, weight, _num_sources = args
    p, s = state.assignment.shape
    b = state.num_brokers
    k = got[0].shape[0]
    half = k - 2 * min(k // 4, b)
    flat = torch.where(candidates_mod.on_source(state, score), weight,
                       torch.full((), float("-inf"), device=weight.device)
                       ).reshape(-1)
    ties = int((flat == flat.max()).sum())
    print(f"K2 select_sources at {label}: ok (exact, k={k}, half={half}, "
          f"B={b}; {int(got[2].sum())} valid rows; {ties} rows at the top "
          f"weight {float(flat.max()):g})")
    line = dict(shape=f"{label}, k={k}", max_abs_err=0.0,
                library_call="torch.topk of the masked flat weights at half "
                             "(partial: the global block only, not in the "
                             "reference's tie order)",
                **measure(lambda: candidates_mod.select_sources(*args),
                          lambda: candidates_mod.select_sources_plain(*args),
                          K2_KERNELS, p * s * (4 + 4) + p + b * 4 + k * 9,
                          p * s, lambda: torch.topk(flat, half)))
    graph, _out = cuda_graph_capture(
        lambda: candidates_mod.select_sources(*args))
    line["graph_launches_per_call"] = cuda_graph_nodes(graph)
    print(f"  K2 at {label}: {line['ms']:.4f} ms by CUDA events, device "
          f"{line['device_ms']} ms, {line['graph_launches_per_call']} "
          f"launches a call in a captured CUDA graph (profiler: "
          f"{line['device_launches_per_call']}), twin "
          f"{line['plain_ms']:.3f} ms, torch.topk {line['library_ms']:.4f} "
          f"ms, bound {line['bound_ms']:.5f} ms")
    return line


def device_ops(fn, reps: int = REPS) -> int:
    """Device ops a call of everything ``fn`` launches (the port's kernels,
    the wrapper's own PyTorch ops, memsets, copies), each op counted
    ``round(records / reps)`` times a call, at least once, as in
    ``device_ms`` (a trace can lose records)."""
    return sum(max(1, round(e.count / reps)) for e in profiled_calls(fn, reps)
               if e.count and str(getattr(e, "device_type", "")).endswith(
                   "CUDA"))


def check_k3(search_mod, call, label: str, timed: bool = True):
    """K3 against its twin: idx, part_ok and has_earlier exactly, and bit
    for bit every f32 output it writes (the selected rows' CandidateDeltas
    fields, the pre-deltas, pot and lbi); with the round's tail (every
    call the round body makes), the final sel exactly against part_ok,
    the joint recheck's twin, the move cap and the freeze flag. Timed:
    its device ops a call, the kernels' and the wrapper's own together
    (at most 3), and its times beside its twin and its bound."""
    import torch

    from cruise_control_tpu_torch.testing import k3_mismatches, k3_plain
    args, kwargs = call
    got = search_mod.select_batch(*args, **kwargs)
    want = k3_plain(args, kwargs)
    bad = k3_mismatches(got, want)
    if bad:
        fail(f"K3 at {label}: {', '.join(bad)} differ from its twin")
    layout, m = args[3], args[4]
    rows = sum(r for r, _c in layout)
    kk = min(m, rows)
    score = args[2]
    tail = args[6]
    joint = tail.recheck
    # The recheck's reads at the brokers its rows touch (the rows are K3's
    # own outputs, counted below).
    ends = torch.cat([got[2].src_broker, got[2].dst_broker])
    recheck_bytes, n_goals = goal_reads(
        joint.state, joint.derived, joint.constraint, joint.goals,
        joint.aux_list, joint.active, joint.prior, kk, kk,
        int(torch.unique(ends[ends >= 0]).numel()))
    print(f"K3 select_batch at {label}: ok ({rows} rows, m={kk}, "
          f"{int(got[1].sum())} considered rows, {int(got[3].sum())} with "
          f"an earlier one, {int(got[6].sum())} selected after the recheck "
          f"of {n_goals} goals and the cap of {tail.moves_cap}"
          f"{' (independent: no cap)' if tail.independent else ''}; exact, "
          "every f32 output bitwise, sel exactly)")
    if not timed:
        return None
    ops_a_call = device_ops(lambda: search_mod.select_batch(*args, **kwargs))
    print(f"  K3 at {label}: {ops_a_call} device ops a call (kernels and "
          "wrapper)")
    if ops_a_call > 3:
        fail(f"K3 at {label}: {ops_a_call} device ops a call (at most 3)")
    # Each input read once: the scores, the picked rows' fields (eight
    # int32, valid, four loads) and two leader loads, and what the recheck
    # reads (``goal_reads``: each row's partition, the per-broker arrays
    # and the goal table once); each output written once (int32 [9, k],
    # f32 [23k], bool [4, k]).
    nbytes = score.numel() * 4 + kk * (8 * 4 + 1 + 4 * 4 + 2 * 4) \
        + recheck_bytes + kk * (9 * 4 + 23 * 4 + 4)
    # What the function needs, not what this kernel does: one compare per
    # score for the per-source reduce, a sort of the kk picked keys for
    # the dedupe and the grouped positions, and ~20 operations a goal a
    # row for the recheck.
    ops = score.numel() + kk * max(1, math.ceil(math.log2(max(kk, 2)))) \
        + kk * 20 * n_goals
    return dict(shape=f"{label}: {rows} rows x {layout}, m={kk}, with the "
                      f"recheck of {n_goals} goals and the move cap",
                max_abs_err=0.0, device_ops_per_call=ops_a_call,
                **measure(lambda: search_mod.select_batch(*args, **kwargs),
                          lambda: k3_plain(args, kwargs),
                          K3_KERNELS, nbytes, ops))


def check_k4(agg_mod, call, label: str) -> dict:
    import torch
    args, kwargs = call
    got = agg_mod.apply_deltas_to_agg(*args, **kwargs)
    want = agg_mod.apply_deltas_to_agg_plain(*args, **kwargs)
    want_cpu = agg_mod.apply_deltas_to_agg_plain(*[to_cpu(a) for a in args])
    card_err = 0.0
    for field in ("broker_load", "broker_replicas", "broker_leaders",
                  "pot_nw_out", "lbi", "topic_counts"):
        a = getattr(got, field)
        if not torch.equal(a.cpu(), getattr(want_cpu, field)):
            fail(f"K4 {field} at {label} differs from the row-order twin")
        if a.dtype.is_floating_point:
            card_err = max(card_err, float((a - getattr(want, field))
                                           .abs().max()))
    agg0, sub0, sel0, _pot0, _lbi0 = args
    m0 = sel0.shape[0]
    bb = agg0.broker_load.shape[0]
    tt = agg0.topic_counts.shape[0]
    dev = sel0.device
    print(f"K4 apply_deltas at {label}: ok (m={m0}, {int(sel0.sum())} "
          f"selected rows; bitwise equal to the twin on the CPU; max abs "
          f"difference {card_err:g} from the twin on the card)")
    stacked_idx = torch.cat([sub0.src_broker, sub0.dst_broker]).long()
    stacked_val = torch.randn(2 * m0, 6, device=dev)
    nbytes = 2 * (bb * (16 + 4 + 4 + 4 + 4) + tt * bb * 4) \
        + m0 * (4 * 5 + 16 + 8 + 1)
    return dict(shape=f"{label}: m={m0}, B={bb}, T={tt}", max_abs_err=0.0,
                card_twin_max_abs_err=card_err,
                **measure(lambda: agg_mod.apply_deltas_to_agg(*args,
                                                              **kwargs),
                          lambda: agg_mod.apply_deltas_to_agg_plain(
                              *args, **kwargs),
                          K4_KERNELS, nbytes, 2 * m0 * 6,
                          lambda: torch.zeros(bb, 6, device=dev)
                          .index_add_(0, stacked_idx, stacked_val)))


def k5_bytes(state, disks) -> int:
    """Bytes one K5 call must move: each slot's broker, disk, DISK load and
    written disk, each partition's movable flag and mask, each disk's
    capacity and state, and the final per-disk loads."""
    p, s = state.assignment.shape
    b, d = disks.disk_capacity.shape
    return p * s * (4 + 4 + 4 + 4) + 2 * p + b * d * (4 + 1 + 4)


def check_k5(disks_mod, state, disks, band, movable, label: str,
             timed: bool = True) -> dict | None:
    """K5 exact against its twin on a CPU copy: the disk assignment and
    the final per-disk loads (K5's load mode against the twin's segment
    sum) bit for bit. Timed beside the twin on the card and its bound,
    whose operations are a compare and an add per slot for every round
    each broker ran. No single PyTorch call runs a loop to a fixed point,
    so it has no library yardstick."""
    import torch
    got = disks_mod.balance_intra_broker(state, disks, 0.8, band, 64,
                                         movable)
    replicas = disks_mod.LAST_CALL["replicas"].cpu()
    rounds = disks_mod.LAST_CALL["rounds"].cpu()
    kinds = disks_mod.LAST_CALL["no_pick_kind"].cpu()
    most = disks_mod.LAST_CALL["max_replicas_per_broker"]
    p, s = state.assignment.shape
    owners = [int(state.assignment.reshape(-1)[f]) for f in
              disks_mod.sentinel_slots(p, s)]
    host = state.to("cpu")
    t0 = time.time()
    want = disks_mod.balance_intra_broker_plain(
        host, disks.to("cpu"), 0.8, band, 64,
        movable.cpu() if movable is not None else None)
    twin_cpu_s = time.time() - t0
    if not torch.equal(got.disk_assignment.cpu(), want.disk_assignment):
        fail(f"K5 at {label}: the disk assignment differs from the twin's")
    loads = disks_mod.disk_load(state, got).cpu()
    want_loads = disks_mod.disk_load(host, want)
    if not torch.equal(loads.view(torch.int32), want_loads.view(torch.int32)):
        fail(f"K5 load mode at {label} differs from the twin's")
    moved = int((got.disk_assignment != disks.disk_assignment).sum())
    if not timed:
        return None
    no_pick = {kind: [b for b in torch.nonzero(kinds == code).flatten()
                      .tolist()] for kind, code in (("pinned", 1),
                                                   ("empty", 2))}
    # A pinned broker writes onto the first sentinel slot, an empty one
    # onto the second; those above the slot's owner undo its moves there.
    blocking = {kind: sum(b > owner for b in no_pick[kind]) if owner >= 0
                else 0 for kind, owner in zip(("pinned", "empty"), owners)}
    print(f"K5 intra_broker at {label}: ok (bitwise equal to the twin on "
          f"the CPU, {moved} replicas moved, rounds a broker up to "
          f"{int(rounds.max())}, {int((rounds > 8).sum())} brokers above 8 "
          f"rounds, largest broker {most} replicas; brokers "
          f"without a pick: {len(no_pick['pinned'])} pinned, "
          f"{len(no_pick['empty'])} empty, above a sentinel owner "
          f"{owners}: {blocking}; twin on the CPU {twin_cpu_s:.2f} s)")
    ops = 2 * int((rounds.to(torch.int64) * replicas.to(torch.int64)).sum())
    line = dict(shape=label, max_abs_err=0.0, max_replicas_per_broker=most,
                max_rounds_per_broker=int(rounds.max()),
                brokers_above_8_rounds=int((rounds > 8).sum()),
                blocking_brokers=blocking, moved=moved,
                library_call="none: no single PyTorch call runs a loop to "
                             "a fixed point",
                **measure(lambda: disks_mod.balance_intra_broker(
                    state, disks, 0.8, band, 64, movable),
                    lambda: disks_mod.balance_intra_broker_plain(
                        state, disks, 0.8, band, 64, movable),
                    K5_KERNELS, k5_bytes(state, disks), ops))
    print(f"  K5 at {label}: {line['ms']:.4f} ms by CUDA events, device "
          f"{line['device_ms']} ms, {line['device_launches_per_call']} "
          f"device launches a call, twin on the card {line['plain_ms']:.3f} "
          f"ms, bound {line['bound_ms']:.5f} ms")
    return line


def k5_load_line(disks_mod, state, disks, label: str,
                 timed: bool = True) -> dict | None:
    """K5's load mode (``disk_load`` on the card) bit for bit against its
    twin on a CPU copy, run under ``torch.cuda.set_sync_debug_mode("error")``
    (no host synchronisation); timed beside its twin and one ``index_add_``
    of the same slots (not in flat slot order). Its bytes: each slot's
    broker, disk and load and each partition's mask read once, the
    [B, D] loads written once; an add a slot."""
    import torch
    b, d = disks.disk_capacity.shape
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = disks_mod.disk_load(state, disks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = disks_mod.disk_load(state.to("cpu"), disks.to("cpu"))
    if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
        fail(f"K5 load mode at {label} differs from the twin's")
    print(f"K5 load mode at {label}: bitwise equal to the twin on the CPU, "
          "no host synchronisation (sync debug mode 'error')")
    if not timed:
        return None
    exists = (state.assignment >= 0) & state.partition_mask[:, None] \
        & (disks.disk_assignment >= 0)
    seg = torch.where(exists, state.assignment.long() * d
                      + disks.disk_assignment.long(), b * d).reshape(-1)
    flat = torch.rand(seg.shape[0], device=state.device)
    p, s = state.assignment.shape
    line = dict(shape=label, max_abs_err=0.0, **measure(
        lambda: disks_mod.disk_load(state, disks),
        lambda: disks_mod._disk_load_plain(state, disks.disk_assignment, d),
        K5L_KERNELS, p * s * 12 + p + b * d * 4, p * s,
        lambda: torch.zeros(b * d + 1, device=state.device)
        .index_add_(0, seg, flat)))
    print(f"  K5 load mode at {label}: {line['ms']:.4f} ms by CUDA events, "
          f"device {line['device_ms']} ms in "
          f"{line['device_launches_per_call']} device ops, twin "
          f"{line['plain_ms']:.4f} ms, index_add_ {line['library_ms']:.4f} "
          f"ms, bound {line['bound_ms']:.5f} ms")
    if line["device_launches_per_call"] != len(K5L_KERNELS):
        fail(f"K5 load mode at {label}: {line['device_launches_per_call']} "
             f"device ops a call, not {len(K5L_KERNELS)}")
    return line


def goal_reads(state, derived, constraint, goals, aux_list, active: int,
               prior, rows: int, sources: int,
               brokers: int) -> tuple[int, int]:
    """(bytes, goals) of what the acceptance of ``rows`` rows over the
    goal table (the prior goals and the active one) reads, each read
    once: each source partition's slots, loads and flags, the per-broker
    arrays' and the goals' [B] arrays' entries of the ``brokers`` brokers
    the rows touch, the goals' [T] and 0-dim arrays; two cells of a
    [T, B] plane and one entry of a [P] array a row."""
    s = state.assignment.shape[1]
    part_bytes = 4 * s + 4 + 32 + 4 + 1 + 1 + s
    nbytes = sources * part_bytes + brokers * (16 + 4 + 4 + 4 + 4 + 4 + 16)
    picked = [i for i in range(len(goals)) if prior[i] or i == active]
    for i in picked:
        for t in goals[i].score_args(state, derived, constraint,
                                     aux_list[i]).arrays:
            if t.dim() == 2:
                nbytes += rows * 2 * t.element_size()
            elif t.dim() == 1 and t.shape[0] == state.num_partitions:
                nbytes += sources * t.element_size()
            elif t.dim() == 1 and t.shape[0] == state.num_brokers:
                nbytes += brokers * t.element_size()
            else:
                nbytes += t.numel() * t.element_size()
    return nbytes, len(picked)


def k6_cost(args) -> tuple[int, int, int]:
    """(rows, bytes, f32 operations) one K6 grid call needs on these
    inputs: each output written once; each input row's own fields and
    ``goal_reads``; ~10 operations a row for its deltas and ~20 a goal a
    row."""
    (r0, c0), (r1, c1) = args[8].layout
    rows, sources = r0 * c0 + r1 * c1, r0 + r1
    table_bytes, n_goals = goal_reads(*args[:7], rows, sources,
                                      args[0].num_brokers)
    nbytes = rows * (1 + 8 * 4 + 16 + 1 + 1 + 4) + table_bytes
    return rows, nbytes, rows * (10 + 20 * n_goals)


def check_k6(sg_mod, k6_mismatches, rec: dict, label: str,
             timed: bool = False) -> dict | None:
    """K6's grid mode against its twin on the card on one round's
    recorded inputs (and, where ``rec`` holds the round's selection, K3
    with the joint recheck against the composition), every output bit
    for bit; timed beside the twin and the bound when ``timed``."""
    bad = k6_mismatches(rec)
    if bad:
        fail(f"K6 at {label}: {bad} differ from the twin")
    if not timed:
        return None
    args = rec["grid"]
    rows, nbytes, ops = k6_cost(args)
    goals = args[3]
    active = goals[args[5]].name
    priors = sum(1 for i in range(len(goals)) if args[6][i])
    line = dict(shape=label, rows=rows, active_goal=active,
                prior_goals=priors, max_abs_err=0.0,
                **measure(lambda: sg_mod.score_grid(*args),
                          lambda: sg_mod.score_grid_plain(*args[:11]),
                          K6_KERNELS, nbytes, ops))
    print(f"K6 score_grid at {label} ({active} active, {priors} prior): "
          f"{rows} rows, {line['ms']:.4f} ms "
          f"(device {line['device_ms']} in "
          f"{line['device_launches_per_call']} device ops), twin "
          f"{line['plain_ms']:.4f} ms, bound {line['bound_ms']:.5f} ms "
          f"({line['bound_by']}); bitwise equal to the twin")
    if line["device_launches_per_call"] != len(K6_KERNELS):
        fail(f"K6 score_grid at {label}: "
             f"{line['device_launches_per_call']} device ops a call, not "
             f"{len(K6_KERNELS)}")
    return line


def check_k6_goals(sg_mod, k6_mismatches, rec: "Recorder", label: str,
                   held: dict) -> None:
    """K6 against its twin on the first recorded round of every goal
    that ran one; their names go into ``held``."""
    for goal, rounds in rec.k6_rounds().items():
        check_k6(sg_mod, k6_mismatches, rounds, f"{label}, {goal} active")
        held.setdefault(goal, []).append(label)


def check_k3_goals(search_mod, rec: "Recorder", label: str,
                   held: dict) -> None:
    """K3 with the joint recheck and the move cap against the composition
    on the first recorded round of every goal that ran one; their names
    go into ``held``."""
    for goal, call in rec.k3_rounds().items():
        check_k3(search_mod, call, f"{label}, {goal} active", timed=False)
        held.setdefault(goal, []).append(label)


def k7_cost(slot_mod, args) -> tuple[int, int]:
    """(bytes, f32 operations) of one K7 call, from what the goal's weight
    family reads on this call's data: every family reads the assignment,
    the leader slot, the partition mask and the [B] alive flags, and
    writes the weight and the offline mask (and with the override the [B]
    offline count); the per-topic families read
    the topic, the rack families the [B] racks, and each family its
    descriptor's arrays, once. A load row is counted where the family
    needs it: every existing slot's row for the load families (16 B, or
    the 4 B of one column; leader slots only where the family weighs
    leaders only), the leader row's column for the leader-load
    family, only the rack duplicates' rows for the rack-duplicate family
    and only the off-set slots' rows for the broker-set family. A peak
    family's max pass rereads what the weight pass reads, counted once.
    ~8 operations a slot."""
    import torch
    fam = slot_mod.WeightFamily
    goal, state, derived, constraint, aux = args[:5]
    wa = goal.weight_args(state, derived, constraint, aux)
    p, s = state.assignment.shape
    b = state.num_brokers
    a = state.assignment.long()
    ex = (a >= 0) & state.partition_mask[:, None]
    slots = torch.arange(s, device=a.device)
    lead = ex & (slots[None, :] == state.leader_slot.long()[:, None])
    nbytes = p * s * 4 + p * 4 + p + b + p * s * (4 + 1) \
        + sum(t.numel() * t.element_size() for t in wa.arrays)
    if args[6]:
        nbytes += b * 4
    if wa.family in (fam.TOPIC_DONOR, fam.BROKER_SET):
        nbytes += p * 4
    if wa.family in (fam.RACK_DUPLICATE, fam.KAFKA_ASSIGNER_RACK):
        nbytes += b * 4
    need, row_bytes = None, 16
    if wa.family in (fam.LOAD_TOTAL, fam.KAFKA_ASSIGNER_RACK):
        need = ex
    elif wa.family == fam.NEG_LOAD_TOTAL:
        need = lead if wa.ival else ex
    elif wa.family in (fam.LOAD_COLUMN, fam.FIT_PRIORITY):
        need, row_bytes = ex, 4
    elif wa.family == fam.LEADER_LOAD:
        # Only leader_load[p, resource]: one column of the leader row.
        need, row_bytes = (lead if wa.ival else ex).any(1, keepdim=True), 4
        lead = torch.ones_like(need)
    elif wa.family == fam.RACK_DUPLICATE:
        rk = torch.where(a >= 0, state.rack.long()[a.clamp(min=0)],
                         -1 - slots[None, :])
        earlier = torch.ones(s, s, dtype=torch.bool,
                             device=a.device).tril(-1)
        need = ((rk[:, :, None] == rk[:, None, :]) & earlier).any(2) & ex
    elif wa.family == fam.BROKER_SET:
        broker_set, home = wa.arrays
        need = ex & (broker_set.long()[a.clamp(min=0)]
                     != home.long()[state.topic.long()][:, None])
    if need is not None:
        rows = int((need & lead).any(1).sum()) \
            + int((need & ~lead).any(1).sum())
        nbytes += rows * row_bytes
    return nbytes, p * s * 8


def check_k7(slot_mod, args, label: str, timed: bool = False,
             want_offline: bool = False):
    """K7 bit for bit against its twin on the card (the twin's ops are
    elementwise: exact on any device) on one call's recorded inputs: the
    weight, the offline mask and flag, and the offline count per broker,
    which with the override must also equal K1's offline twin on a CPU
    copy exactly (zeros without it); with ``want_offline`` the input must
    hold offline replicas. Timed beside the twin and the bound of the
    goal's family when ``timed``, and then its device ops a call must be
    at most 2 (4 for the families with a max pass)."""
    import torch

    from cruise_control_tpu_torch.analyzer.agg import (
        offline_per_broker_plain,
    )
    goal, state, override = args[0], args[1], args[6]
    got = slot_mod.slot_weights(*args)
    want = slot_mod.slot_weights_plain(*args[:5], override)
    for name, a, b in zip(("weight", "off", "off_any", "count"), got, want,
                          strict=True):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            fail(f"K7 {name} at {label} ({goal.name}, override "
                 f"{override}) differs from its twin")
    count = got[3].cpu()
    want_count = offline_per_broker_plain(state.to("cpu")).to(torch.int32) \
        if override else torch.zeros_like(count)
    if not torch.equal(count, want_count):
        fail(f"K7's offline count at {label} ({goal.name}, override "
             f"{override}) differs from K1's offline twin")
    offline = int(count.sum())
    if want_offline and not offline:
        fail(f"K7 at {label} ({goal.name}): the input has no offline "
             "replica, so the count check saw only zeros")
    if not timed:
        return None
    nbytes, ops = k7_cost(slot_mod, args)
    family = goal.weight_args(*args[1:5]).family.name
    line = dict(shape=f"{label}, {goal.name} ({family}), override "
                      f"{override}", family=family, max_abs_err=0.0,
                offline_counted=offline, library_call=None,
                **measure(lambda: slot_mod.slot_weights(*args),
                          lambda: slot_mod.slot_weights_plain(
                              *args[:5], override), K7_KERNELS, nbytes, ops))
    ops_limit = 4 if family in ("FIT_PRIORITY", "KAFKA_ASSIGNER_RACK") else 2
    print(f"K7 slot_weights at {line['shape']}: {line['ms']:.4f} ms (device "
          f"{line['device_ms']}, {line['device_launches_per_call']} device "
          f"ops a call, at most {ops_limit}), twin {line['plain_ms']:.4f} "
          f"ms, bound {line['bound_ms']:.5f} ms ({line['bound_by']}, "
          f"{nbytes} bytes); bitwise equal to the twin, {offline} offline "
          "replicas counted")
    if (line["device_launches_per_call"] or 0) > ops_limit:
        fail(f"K7 at {line['shape']} took "
             f"{line['device_launches_per_call']} device ops a call")
    return line


def check_k7_goals(slot_mod, rec: "Recorder", label: str, held: dict,
                   family_lines: dict | None = None) -> None:
    """K7 against its twin on the first recorded call of every goal with
    the offline override (move rounds of goals that move replicas) and
    without it (swap rounds, and the move rounds of leadership goals).
    With ``family_lines``, the first call of each weight family not yet
    in it is timed and its line stored under the family's name."""
    for (goal, override), args in rec.k7_calls().items():
        family = args[0].weight_args(*args[1:5]).family.name
        timed = family_lines is not None and family not in family_lines
        line = check_k7(slot_mod, args, f"{label}, {goal} active", timed)
        if timed:
            family_lines[family] = line
        held.setdefault(goal, []).append(
            f"{label} (override {'on' if override else 'off'})")


def check_k2_leadership(cand_mod, args, label: str, timed: bool = True):
    """K2's leadership mode exact against its twin (values bit for bit,
    partitions, top_k's -inf padding); timed: its device ops a call (at
    most K2L_MAX_OPS) and its times beside the twin, the bound and
    ``torch.topk`` of the masked leader weights (not in the reference's
    tie order)."""
    import torch

    from cruise_control_tpu_torch.model.tensors import is_leader_slot
    state, score, weight, num_sources = args
    got = cand_mod.leadership_sources(*args)
    want = cand_mod.leadership_sources_plain(*args)
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        fail(f"K2 leadership mode at {label} differs from its twin")
    p, s = state.assignment.shape
    b = state.num_brokers
    k = got[0].shape[0]
    flat = torch.where(cand_mod.on_source(state, score)
                       & is_leader_slot(state), weight,
                       torch.full((), float("-inf"), device=weight.device)
                       ).reshape(-1)
    finite = int(torch.isfinite(got[0]).sum())
    top = float(flat.max())
    ties = int((flat == top).sum())
    print(f"K2 leadership mode at {label}: ok (exact, k={k}; {finite} finite "
          f"rows, {k - finite} padding rows; {ties} leader slots at the top "
          f"weight {top:g})")
    if not timed:
        return None
    ops_a_call = device_ops(lambda: cand_mod.leadership_sources(*args))
    print(f"  K2 leadership at {label}: {ops_a_call} device ops a call")
    if ops_a_call > K2L_MAX_OPS:
        fail(f"K2 leadership mode at {label}: {ops_a_call} device ops a call "
             f"(at most {K2L_MAX_OPS})")
    line = dict(shape=f"{label}, k={k}", max_abs_err=0.0,
                device_ops_per_call=ops_a_call,
                library_call="torch.topk of the masked leader weights over "
                             "P*S (not in the reference's tie order)",
                **measure(lambda: cand_mod.leadership_sources(*args),
                          lambda: cand_mod.leadership_sources_plain(*args),
                          K2L_KERNELS, p * (4 + 1 + 4 + 4) + b * 4 + k * 8,
                          p, lambda: torch.topk(flat, k)))
    print(f"  K2 leadership at {label}: {line['ms']:.4f} ms by CUDA events, "
          f"device {line['device_ms']} ms ({line['device_launches_per_call']}"
          f" device ops a call), twin {line['plain_ms']:.3f} ms, torch.topk "
          f"{line['library_ms']:.4f} ms, bound {line['bound_ms']:.5f} ms")
    return line


def check_k8(search_mod, args, label: str, timed: bool = True):
    """K8 exact against its twin (indices, validity, padding); timed
    beside the twin, the bound and ``torch.topk`` of the masked [k, P*S]
    keys of both sides (not in the reference's tie order)."""
    import torch
    state, weight, src_b, dst_b, j = args
    got = search_mod.swap_top_replicas(*args)
    want = (*search_mod._per_broker_top_replicas(state, weight, src_b, j,
                                                  largest=True),
            *search_mod._per_broker_top_replicas(state, weight, dst_b, j,
                                                  largest=False))
    for name, a, b in zip(("heavy_idx", "heavy_ok", "light_idx",
                           "light_ok"), got, want):
        if not torch.equal(a, b):
            fail(f"K8 {name} at {label} differs from its twin")
    padded = int((~got[1]).sum() + (~got[3]).sum())
    print(f"K8 swap_top_replicas at {label}: ok (exact, k={src_b.shape[0]}, "
          f"j={j}; {padded} padding rows)")
    if not timed:
        return None
    ops_a_call = device_ops(lambda: search_mod.swap_top_replicas(*args))
    print(f"  K8 at {label}: {ops_a_call} device ops a call (kernel and "
          "wrapper)")
    if ops_a_call > K8_MAX_OPS:
        fail(f"K8 at {label}: {ops_a_call} device ops a call (at most "
             f"{K8_MAX_OPS})")
    from cruise_control_tpu_torch.model.tensors import (
        broker_segments, replica_exists,
    )
    p, s = state.assignment.shape
    seg = broker_segments(state).reshape(-1)
    flat_w = torch.where(replica_exists(state), weight, torch.full(
        (), float("nan"), device=weight.device)).reshape(-1)
    ninf = torch.full((), float("-inf"), device=weight.device)
    keys = []
    for brokers, sign in ((src_b, 1.0), (dst_b, -1.0)):
        on_b = (seg[None, :] == brokers.long()[:, None]) \
            & torch.isfinite(flat_w)[None, :]
        keys.append(torch.where(on_b, sign * flat_w[None, :], ninf))
    hits = int(torch.isfinite(keys[0]).sum() + torch.isfinite(keys[1]).sum())
    line = dict(shape=f"{label}, k={src_b.shape[0]}, j={j}", max_abs_err=0.0,
                device_ops_per_call=ops_a_call,
                library_call="torch.topk of the masked [k, P*S] keys, both "
                             "sides (not in the reference's tie order)",
                **measure(lambda: search_mod.swap_top_replicas(*args),
                          lambda: (
                              search_mod._per_broker_top_replicas(
                                  state, weight, src_b, j, largest=True),
                              search_mod._per_broker_top_replicas(
                                  state, weight, dst_b, j, largest=False)),
                          K8_KERNELS,
                          p * s * 4 + hits * 5 + 4 * src_b.shape[0] * j * 5,
                          p * s * 2 * src_b.shape[0],
                          lambda: (torch.topk(keys[0], j),
                                   torch.topk(keys[1], j))))
    print(f"  K8 at {label}: {line['ms']:.4f} ms by CUDA events, device "
          f"{line['device_ms']} ms ({line['device_launches_per_call']} "
          f"device ops a call), twin {line['plain_ms']:.3f} ms, torch.topk "
          f"{line['library_ms']:.4f} ms, bound {line['bound_ms']:.5f} ms "
          f"({line['bound_by']})")
    return line


def k8_crafted_cases(state, seed: int):
    """(label, weight, src_b, dst_b) tie cases for K8 on ``state``: every
    weight equal; signed zeros; a source broker with one finite replica
    and a destination broker with none; overlapping broker lists."""
    import torch
    dev = state.device
    b = state.num_brokers
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = tuple(state.assignment.shape)
    src_b = torch.randperm(b, generator=gen)[:8].to(torch.int32)
    dst_b = torch.cat([src_b[:3], torch.randperm(b, generator=gen)[:5]
                       .to(torch.int32)])
    zeros = torch.where(torch.rand(shape, generator=gen) < 0.5,
                        torch.tensor(0.0), torch.tensor(-0.0))
    few = torch.randn(shape, generator=gen)
    a = state.assignment.cpu().reshape(-1)
    for broker, keep in ((int(src_b[0]), 1), (int(dst_b[7]), 0)):
        on = torch.nonzero(a == broker)[:, 0]
        few.reshape(-1)[on[keep:]] = float("nan")
    return [(name, w.to(dev), src_b.to(dev), dst_b.to(dev)) for name, w in (
        ("every weight equal", torch.ones(shape)),
        ("signed zeros", zeros),
        ("one finite replica, none on one broker", few))]


SORT_OPS = ("aten::sort", "aten::argsort", "aten::topk", "aten::msort")


def largest_sort_input(fn, ops=SORT_OPS) -> int:
    """The most keys any sort or top-k (any op of ``ops``) of one eager
    call of ``fn`` takes (the profiler's recorded input shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return max((math.prod(e.input_shapes[0]) for e in prof.events()
                if e.name in ops and e.input_shapes
                and e.input_shapes[0]), default=0)


def check_round_launches(launches: dict, loop: dict, label: str) -> None:
    """K7 once per move round and per swap round, K2's leadership mode
    once per move round (as K6's grid), K8 once per swap round, and K1's
    offline mode never (K7 counts the round's offline replicas)."""
    lead = launches.get("select_leadership", 0)
    swap = launches.get("swap_top_replicas", 0)
    if lead != launches.get("score_grid", 0):
        fail(f"{label}: K2's leadership mode ran {lead} times, K6's grid "
             f"{launches.get('score_grid', 0)}")
    if swap != loop.get("swap_device_rounds", 0):
        fail(f"{label}: K8 ran {swap} times in "
             f"{loop.get('swap_device_rounds', 0)} swap rounds")
    if launches.get("slot_weights", 0) != lead + swap:
        fail(f"{label}: K7 ran {launches.get('slot_weights', 0)} times in "
             f"{lead} move and {swap} swap rounds")
    if launches.get("segment_reduce_offline", 0):
        fail(f"{label}: K1's offline mode ran "
             f"{launches['segment_reduce_offline']} times (K7 counts the "
             "round's offline replicas)")
    if launches.get("score_grid_recheck", 0):
        fail(f"{label}: K6's recheck mode ran "
             f"{launches['score_grid_recheck']} times (K3 rechecks)")
    if launches.get("select_batch", 0) != lead:
        fail(f"{label}: K3 ran {launches.get('select_batch', 0)} times in "
             f"{lead} move rounds")
    print(f"{label}: K7 {lead + swap} launches = {lead} move rounds + {swap} "
          f"swap rounds (K2 leadership {lead}, K3 with the recheck {lead}, "
          f"K8 {swap}); K1's offline mode 0, K6's recheck mode 0")


def outcome_check(name: str, got: dict, want: dict, fields, result) -> None:
    """Print the comparison with the reference (digests, the first goal
    whose moves differ, proposals, dispatch statistics), then fail unless
    every hard goal succeeded and ``fields`` and the violation
    fingerprint equal the reference's."""
    from cruise_control_tpu_torch.testing import first_goal_differing
    stats_got, stats_want = got["dispatch_stats"], want["dispatch_stats"]
    print(f"{name}: assignment digest equal: "
          f"{got['assignment_sha256'] == want['assignment_sha256']}; "
          f"leader digest equal: "
          f"{got['leader_slot_sha256'] == want['leader_slot_sha256']}; "
          f"first goal whose moves differ: {first_goal_differing(got, want)}"
          f"; proposals {got['num_proposals']} (reference "
          f"{want['num_proposals']}); dispatch stats equal: "
          f"{stats_got == stats_want} ({got['dispatch_stats']})")
    failed_hard = [g.name for g in result.goal_results
                   if g.is_hard and not g.succeeded]
    if failed_hard:
        fail(f"{name}: hard goals failed: {failed_hard}")
    for key in fields:
        if got[key] != want[key]:
            fail(f"{name}: {key} {got[key]!r} differs from the reference's "
                 f"{want[key]!r}")
    # The fingerprint hashes the entry violations, which no dispatch
    # boundary moves, so every run is held to it.
    fp_got = stats_got.get("violation_fingerprint")
    fp_want = stats_want.get("violation_fingerprint")
    if fp_got != fp_want:
        fail(f"{name}: violation_fingerprint {fp_got!r} differs from the "
             f"reference's {fp_want!r}")
    print(f"{name}: matches the reference on {', '.join(fields)} and the "
          f"violation fingerprint {fp_got}; every hard goal satisfied")


def solve_summary(label, result, wall) -> int:
    rounds = sum(g.rounds for g in result.goal_results)
    print(f"{label}: {wall:.3f} s, {rounds} rounds, balancedness "
          f"{result.balancedness_before:.2f} -> "
          f"{result.balancedness_after:.2f}, {len(result.proposals)} "
          f"proposals")
    return rounds


def loop_summary(label: str, stats: dict, steady: bool = False) -> dict:
    """Print a solve's round-loop accounting (``last_loop_stats()``): the
    graphs it captured and their seconds, replays, host reads and frozen
    rounds. A steady solve must capture nothing."""
    reads = stats.get("dispatch_reads", 0) + stats.get("live_polls", 0) \
        + stats.get("stats_reads", 0)
    device_rounds = stats.get("device_rounds", 0)
    frozen = stats.get("frozen_rounds", 0)
    print(f"{label}: graphs captured {stats.get('captures', 0)} "
          f"({stats.get('capture_s', 0.0):.3f} s, eager warm-up rounds "
          f"included), replays {stats.get('replays', 0)}, host reads {reads} "
          f"({stats.get('dispatch_reads', 0)} dispatch, "
          f"{stats.get('live_polls', 0)} live polls, "
          f"{stats.get('stats_reads', 0)} goal statistics), device rounds "
          f"{device_rounds} of which frozen {frozen} "
          f"({frozen / max(device_rounds, 1):.1%})")
    if steady and stats.get("captures", 0):
        fail(f"{label}: a steady solve captured {stats['captures']} graphs")
    if not stats.get("replays", 0):
        fail(f"{label}: no graph was replayed")
    return dict(stats, host_reads=reads)


def speculative_cost(chain_mod, bounded_solve, ref, fields,
                     steady_s: float) -> dict:
    """What the async pump's speculative dispatches cost on the pinned
    1k/100k solve: one solve with every dispatch timed (a device sync on
    each side; the speculative one is the last of its pass), then one
    with ``solver.dispatch.async.readback=false``, which makes none."""
    import torch
    orig = chain_mod.run_bounded_pass
    tally = dict(dispatches=0, dispatch_s=0.0, speculative=0,
                 speculative_s=0.0)

    def timed_pass(enqueue, st, *args, **kwargs):
        walls = []

        def timed_enqueue(s, budget):
            torch.cuda.synchronize()
            t0 = time.time()
            out = enqueue(s, budget)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            return out

        stats = kwargs.get("stats")
        before = stats.speculative if stats is not None else 0
        out = orig(timed_enqueue, st, *args, **kwargs)
        tally["dispatches"] += len(walls)
        tally["dispatch_s"] += sum(walls)
        if stats is not None and stats.speculative > before:
            tally["speculative"] += stats.speculative - before
            tally["speculative_s"] += walls[-1]
        return out

    chain_mod.run_bounded_pass = timed_pass
    try:
        *_x, res_t, got_t, timed_s, _r = bounded_solve(
            "1k_100k", ref["config"], "bounded solve 1k/100k, dispatches "
            "timed")
    finally:
        chain_mod.run_bounded_pass = orig
    outcome_check("1k/100k pinned, dispatches timed", got_t, ref, fields,
                  res_t)
    if tally["speculative"] != got_t["dispatch_stats"][
            "speculative_dispatches"]:
        fail("the timed solve lost track of its speculative dispatches")
    share = tally["speculative_s"] / timed_s
    print(f"speculative dispatches: {tally['speculative']} of "
          f"{tally['dispatches']}, {tally['speculative_s']:.3f} s of the "
          f"timed solve's {timed_s:.3f} s = {share:.1%} (all dispatches "
          f"{tally['dispatch_s']:.3f} s)")
    conf_off = dict(ref["config"])
    conf_off["solver.dispatch.async.readback"] = "false"
    *_x, res_o, got_o, off_s, _r = bounded_solve(
        "1k_100k", conf_off, "bounded solve 1k/100k, async readback off")
    outcome_check("1k/100k pinned, async readback off", got_o, ref, fields,
                  res_o)
    print(f"async readback off: {off_s:.3f} s against {steady_s:.3f} s "
          f"with it on; dispatches {got_o['dispatch_stats']}")
    return dict(tally, timed_solve_s=timed_s, share_of_timed_solve=share,
                async_off_s=off_s, async_on_s=steady_s,
                async_off_dispatch=got_o["dispatch_stats"])


# The direct-assignment transport's kernels KD1-KD4: their device kernels
# (profiler names), sources and the reference code they replace.
DIRECT_KERNELS = {
    "direct_sort": ["count_kernel", "pass_kernel"],
    "segment_scan": ["scan_kernel"],
    "direct_plan": ["plan_kernel"],
    "direct_fill": ["fill_kernel"],
}
# The device ops of one call of KD2, KD3 and KD4.
DIRECT_OPS = {"segment_scan": 1, "direct_plan": 1, "direct_fill": 1}


def direct_ops_limit(kernel, args) -> int:
    """The most device ops one call may take: KD1 one count launch and a
    launch a radix pass (4 over a second key, one a byte of the key);
    the others ``DIRECT_OPS``."""
    if kernel != "direct_sort":
        return DIRECT_OPS[kernel]
    from cruise_control_tpu_torch.analyzer.direct_kernels import key_bits
    second = args[2] if len(args) > 2 else None
    return 1 + (4 if second is not None else 0) \
        + -(-key_bits(int(args[1])) // 8)
DIRECT_REPLACES = {
    "direct_sort": ("cruise_control_tpu_torch/csrc/direct_sort.cu",
                    "cruise_control_tpu/analyzer/direct.py:653"),
    "segment_scan": ("cruise_control_tpu_torch/csrc/segment_scan.cu",
                     "cruise_control_tpu/analyzer/direct.py:234"),
    "direct_plan": ("cruise_control_tpu_torch/csrc/direct_plan.cu",
                    "cruise_control_tpu/analyzer/direct.py:319"),
    "direct_fill": ("cruise_control_tpu_torch/csrc/direct_fill.cu",
                    "cruise_control_tpu/analyzer/fill.py:119"),
}
# PyTorch ops a direct sweep must not run over P*S elements on the card.
DIRECT_FORBIDDEN_OPS = SORT_OPS + ("aten::cumsum", "aten::searchsorted",
                                   "aten::cummax")


class DirectRecorder:
    """Wraps KD1-KD4's wrappers as ``analyzer/direct.py`` calls them and
    keeps cloned inputs of the first call of each (kernel, goal, variant)
    and of the largest call of each kernel, and each goal's entry to the
    transport (the arguments of ``direct_transport_rounds``)."""

    def __init__(self, direct_mod):
        self.calls = {}
        self.largest = {}
        self.entries = {}
        self._goal = None
        self._mod = direct_mod
        self._orig = {}
        for attr, kernel in (("sort_pairs", "direct_sort"),
                             ("segment_scan", "segment_scan"),
                             ("direct_plan", "direct_plan"),
                             ("direct_fill_dests", "direct_fill")):
            self._wrap(attr, kernel)
        orig = direct_mod.direct_transport_rounds
        self._orig["direct_transport_rounds"] = orig

        def rounds(state, goals, index, *args, **kwargs):
            self._goal = goals[index].name
            if self._goal not in self.entries:
                self.entries[self._goal] = snapshot(
                    ((state, goals, index) + args, kwargs))
            return orig(state, goals, index, *args, **kwargs)

        direct_mod.direct_transport_rounds = rounds

    @staticmethod
    def _variant(kernel, args) -> tuple[str, int]:
        """(variant, size) of one call."""
        if kernel == "direct_sort":
            second = args[2] if len(args) > 2 else None
            return ("pairs" if second is not None else "keyed",
                    args[0].numel())
        if kernel == "segment_scan":
            checks = args[2] if len(args) > 2 else ()
            kind = "int" if not args[1].is_floating_point() else (
                "checks" if checks else "f32")
            return kind, args[1].numel()
        return kernel, args[0].numel()

    def _wrap(self, attr, kernel):
        orig = getattr(self._mod, attr)
        self._orig[attr] = orig

        def wrapper(*args, **kwargs):
            variant, size = self._variant(kernel, args)
            key = (kernel, self._goal, variant)
            if key not in self.calls:
                self.calls[key] = snapshot((args, kwargs))
            best = self.largest.get(kernel)
            if best is None or size > best[0]:
                self.largest[kernel] = (size, self._goal, variant,
                                        snapshot((args, kwargs)))
            return orig(*args, **kwargs)

        setattr(self._mod, attr, wrapper)

    def restore(self):
        for attr, orig in self._orig.items():
            setattr(self._mod, attr, orig)


def _direct_fns(kernel):
    """(wrapper, plain twin on the args' device) of one KD kernel."""
    from cruise_control_tpu_torch.analyzer import direct_kernels as dk
    from cruise_control_tpu_torch.analyzer import fill as fill_mod

    def scan_plain(keys, values, checks=(), perm=None):
        excl = dk.segment_exclusive_plain(keys, values)
        return excl, (dk.check_verdicts_plain(keys, values, excl, checks,
                                              perm) if checks else None)

    def plan_plain(*args):
        import torch
        surplus, defi, headr = dk.surplus_deficit_plain(*args)
        return surplus, defi, headr, torch.cumsum(defi, 1), \
            torch.cumsum(headr, 1)

    def sort_plain(key, _key_max, second=None):
        return dk.sort_pairs_plain(key, second)

    return {"direct_sort": (dk.sort_pairs, sort_plain),
            "segment_scan": (dk.segment_scan, scan_plain),
            "direct_plan": (dk.direct_plan, plan_plain),
            "direct_fill": (fill_mod.direct_fill_dests,
                            fill_mod.fill_from_profiles)}[kernel]


def check_direct(kernel, call, label: str) -> None:
    """One KD call on the card against its twin run on a CPU copy of the
    same inputs: KD1's permutation and keys and KD4's destinations
    exact, KD2's sums and verdicts and KD3's planes bit for bit."""
    import torch
    args, kwargs = call
    fn, _plain = _direct_fns(kernel)
    got = fn(*args, **kwargs)
    want = fn(*to_cpu(args), **to_cpu(kwargs))
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if a is None and b is None:
            continue
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            fail(f"{kernel} at {label}: output {i} differs from its twin "
                 f"in {bad} of {a.numel()} elements")


def direct_cost(kernel, args) -> tuple[int, int]:
    """(bytes, f32 ops) the call's function must move and do: each input
    read once and each output written once."""
    if kernel == "direct_sort":
        n = args[0].numel()
        second = args[2] if len(args) > 2 else None
        return n * (4 + (4 if second is not None else 0) + 8), 0
    if kernel == "segment_scan":
        keys, values = args[0], args[1]
        checks = args[2] if len(args) > 2 else ()
        n, v = keys.numel(), values.numel()
        extra = (4 * n + n + sum(n for c in checks if c.gate is not None)
                 + sum(8 * c.limit.numel() for c in checks)) if checks else 0
        return 4 * n + 8 * v + extra, v + 4 * n * len(checks)
    if kernel == "direct_plan":
        g, b = args[0].shape
        return 4 * g * b + 8 * g + 2 * b + 20 * g * b, 40 * g * b
    n = args[0].numel()
    g, b = args[2].shape
    return 8 * n + 8 * g * b + 5 * n, 4 * n * max(1, b.bit_length())


def direct_library_fn(kernel, args):
    """The one PyTorch call that computes the same function (timed as a
    yardstick, never called by the port), or None."""
    import torch
    from cruise_control_tpu_torch.analyzer import direct_kernels as dk
    from cruise_control_tpu_torch.utils.numerics import total_order_key
    if kernel == "direct_sort":
        key = args[0]
        second = args[2] if len(args) > 2 else None
        if second is None:
            return lambda: torch.sort(key, stable=True)
        comp = key.long() * 2 ** 32 + total_order_key(
            dk.sort_order_second(second)).long() + 2 ** 31
        return lambda: torch.sort(comp, stable=True)
    if kernel == "segment_scan":
        # No PyTorch call scans segments: the yardstick is one unsegmented
        # 1-D cumsum over the same N*R values, laid out column by column
        # (the copy made outside the timed call). PyTorch scans [N, R]
        # along dim 0, or [R, N] along dim 1, with few CTAs when R is
        # small: 400 ms and 4.6 ms at 3M x 4 on the H100.
        flat = args[1].reshape(args[1].shape[0], -1).t().contiguous() \
            .reshape(-1)
        return lambda: torch.cumsum(flat, 0)
    if kernel == "direct_fill":
        group, rank, cum_d, _cum_h = args
        span = float(cum_d.max()) + 2.0
        rows = torch.arange(cum_d.shape[0], device=cum_d.device)
        flat = (cum_d + rows[:, None] * span).reshape(-1)
        q = rank + 0.5 + group * span
        return lambda: torch.searchsorted(flat, q, right=True)
    return None


def direct_line(kernel, call, label: str) -> dict:
    """A KD kernel's timed line on one recorded call: CUDA-event and
    profiler times, its plain twin on the card, its bound and the library
    call's time."""
    args, kwargs = call
    fn, plain = _direct_fns(kernel)
    nbytes, ops = direct_cost(kernel, args)
    line = dict(shape=label, max_abs_err=0.0, **measure(
        lambda: fn(*args, **kwargs), lambda: plain(*args, **kwargs),
        DIRECT_KERNELS[kernel], nbytes, ops,
        library_fn=direct_library_fn(kernel, args), reps=10))
    ops = line["device_launches_per_call"]
    limit = direct_ops_limit(kernel, args)
    line["device_ops_limit"] = limit
    if ops is not None and ops > limit:
        fail(f"{kernel} at {label}: {ops} device ops a call, above its "
             f"{limit}")
    print(f"{kernel} at {label}: {line['ms']:.4f} ms (device "
          f"{line['device_ms']}, {line['device_launches_per_call']} device "
          f"ops a call), twin on the card {line['plain_ms']:.4f} ms, "
          f"library {line['library_ms']}, bound {line['bound_ms']:.5f} ms "
          f"({line['bound_by']}, {nbytes} bytes); equal to its twin")
    return line


def check_direct_recorded(rec: DirectRecorder, label: str) -> list[str]:
    """Every recorded KD call (the first of each kernel, goal and
    variant, and each kernel's largest) against its twin; returns what was
    held."""
    held = []
    for (kernel, goal, variant), call in sorted(rec.calls.items(),
                                                key=lambda kv: str(kv[0])):
        check_direct(kernel, call, f"{label}, {goal}, {variant}")
        held.append(f"{kernel}/{goal}/{variant}")
    for kernel, (size, goal, variant, call) in rec.largest.items():
        check_direct(kernel, call, f"{label}, largest call ({size:,} "
                     f"elements, {goal}, {variant})")
    return held


def sweep_without_sync(direct_mod, entry, label: str) -> None:
    """One sweep of the goal's transport from its recorded entry state
    under ``torch.cuda.set_sync_debug_mode("error")``: no host
    synchronisation inside a sweep."""
    import torch
    (state, goals, index, constraint, num_topics, masks, *_r), kwargs = entry
    sweep_fn = direct_mod._sweep_fn(goals, index)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sweep_fn(state, goals, index, constraint, num_topics, masks,
                 sweep=1, margin_frac=kwargs.get("margin_frac", 0.25),
                 seed=kwargs["seed"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{label}: one {sweep_fn.__name__} of {goals[index].name} ran "
          "under sync debug mode 'error' (no host synchronisation)")


def direct_outcome_check(name: str, got: dict, want: dict) -> None:
    """Each goal's direct moves and sweeps equal to the reference's."""
    g = [(x["name"], x["direct_moves"], x["direct_sweeps"])
         for x in got["goals"]]
    w = [(x["name"], x["direct_moves"], x["direct_sweeps"])
         for x in want["goals"]]
    if g != w:
        fail(f"{name}: direct moves and sweeps per goal {g} differ from "
             f"the reference's {w}")
    print(f"{name}: direct moves and sweeps per goal equal the "
          f"reference's: {[x for x in g if x[2]]}")


class Phase:
    """Prints a phase's wall when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[phase {self.name}: {time.time() - self.t0:.1f} s]",
                  flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        from cruise_control_tpu_torch import kernels
        from cruise_control_tpu_torch.analyzer import agg as agg_mod
        from cruise_control_tpu_torch.analyzer import candidates as cand_mod
        from cruise_control_tpu_torch.analyzer import chain as chain_mod
        from cruise_control_tpu_torch.analyzer import optimizer as opt_mod
        from cruise_control_tpu_torch.analyzer import score_grid as sg_mod
        from cruise_control_tpu_torch.analyzer import search as search_mod
        from cruise_control_tpu_torch.analyzer import slot_pass as slot_mod
        from cruise_control_tpu_torch.analyzer.constraint import (
            BalancingConstraint, OptimizationOptions,
        )
        from cruise_control_tpu_torch.analyzer.derived import compute_derived
        from cruise_control_tpu_torch.analyzer.goals import ALL_GOALS
        from cruise_control_tpu_torch.analyzer.goals.intra_broker import (
            IntraBrokerDiskCapacityGoal, IntraBrokerDiskUsageDistributionGoal,
        )
        from cruise_control_tpu_torch.analyzer.optimizer import (
            GoalOptimizer, goals_by_priority,
        )
        from cruise_control_tpu_torch.model import disks as disks_mod
        from cruise_control_tpu_torch.model.stats import cluster_stats
        from cruise_control_tpu_torch.config import CruiseControlConfig
        from cruise_control_tpu_torch.common.broker_state import BrokerState
        from cruise_control_tpu_torch.model.fixtures import Dist, random_cluster
        from cruise_control_tpu_torch.model.tensors import (
            cluster_from_numpy, cluster_to_numpy, set_broker_state,
        )
        from cruise_control_tpu_torch.testing import (
            DISK_OUTCOME_FIELDS, K5_EDGE_CASES, K6_CHAINS, K7_FAMILY_GOALS,
            OUTCOME_FIELDS, SENTINEL_CASES, build_fixture, disk_outcome,
            entry_disks, k2_round_inputs, k5_edge_case, k7_family_goal,
            k4_adversarial_batch, k4_drain_batch, k6_goals, k6_mismatches,
            k6_round_inputs, last_broker_ids,
            crowded_broker_case, load_reference_outcomes, outcome,
            random_disk_case,
            random_placement_disks, sentinel_case, swap_grid_inputs,
        )
    except ImportError as exc:
        print(f"the port package is missing beside chip_smoke.py: {exc}",
              file=sys.stderr)
        return 3

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------------
    with Phase("build"):
        t0 = time.time()
        reports = kernels.build_all()
        print(f"kernel build: {time.time() - t0:.2f} s "
              f"({len(reports)} libraries built)")
        for name, log in reports.items():
            kernel = ""
            for line in log.splitlines():
                entry = re.search(r"Compiling entry function '.*?\d([a-z_]+"
                                  r"_kernel)", line)
                if entry:
                    kernel = entry.group(1)
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name} {kernel}: {line.strip()}")
        k3_smem = kernels.library("select_batch").cc_select_batch_smem_bytes(
            CAP_ROWS, CAP_M)
        print(f"  ptxas select_batch select_kernel: dynamic shared memory "
              f"{k3_smem:,} bytes a CTA at {CAP_ROWS} rows, m = {CAP_M} "
              "(a cluster of four CTAs)")

    cfg = CruiseControlConfig()
    opt = GoalOptimizer(cfg, device="cuda")
    state, meta = random_cluster(**SIZE, dist=Dist.EXPONENTIAL, device=dev)
    torch.cuda.synchronize()
    shapes_100 = "100/10k"

    # -- 2. fused warm-up, kernels against their twins at 100/10k -------------
    with Phase("fused 100/10k warm-up and kernel checks"):
        rec = Recorder(chain_mod, search_mod)
        t0 = time.time()
        warm_final, warm = opt.optimizations(state, meta,
                                             goals=goals_by_priority(cfg))
        torch.cuda.synchronize()
        rec.restore()
        warm_100_s = time.time() - t0
        solve_summary("fused warm-up solve 100/10k", warm, warm_100_s)
        warm_loop_100 = loop_summary("fused warm-up 100/10k",
                                     opt.last_loop_stats())
        for key in Recorder.KEYS:
            if not rec.calls[key]:
                fail(f"warm-up never reached {key}")
        (k1_state, k1_topics), _ = rec.calls["segment_reduce"][0]
        err = check_k1(agg_mod, k1_state, k1_topics, shapes_100)
        lines_100 = {
            "segment_reduce": k1_line(agg_mod, k1_state, k1_topics, err,
                                      shapes_100),
            "select_sources": check_k2(
                cand_mod, rec.calls["select_sources"][0][0], shapes_100),
            "select_batch": check_k3(search_mod,
                                     rec.calls["select_batch"][0],
                                     shapes_100),
            "apply_deltas": check_k4(agg_mod, rec.calls["apply_deltas"][0],
                                     shapes_100)}
        # K6 on the first round's inputs (timed) and on every goal's first
        # round (goal name -> where K6 was held to its twin).
        k6_held = {}
        lines_100["score_grid"] = check_k6(
            sg_mod, k6_mismatches, {"grid": rec.calls["score_grid"][0][0]},
            shapes_100, timed=True)
        check_k6_goals(sg_mod, k6_mismatches, rec, shapes_100, k6_held)
        # K3 with the recheck on every goal's first round (goal name ->
        # where it was held to the composition).
        k3_held = {}
        check_k3_goals(search_mod, rec, shapes_100, k3_held)
        # K7 on every goal's first move and swap round (goal name -> where
        # K7 was held to its twin), timed on the first; K2's leadership
        # mode and K8 on their first calls.
        k7_held = {}
        # K7's timed line of each weight family, from the largest solve
        # that ran the family (a direct call at 100/10k for the rest).
        k7_families = {}
        check_k7_goals(slot_mod, rec, shapes_100, k7_held)
        lines_100["slot_weights"] = check_k7(
            slot_mod, rec.calls["slot_weights"][0][0], shapes_100,
            timed=True)
        lines_100["select_leadership"] = check_k2_leadership(
            cand_mod, rec.calls["select_leadership"][0][0],
            shapes_100)
        if rec.calls["swap_top_replicas"]:
            lines_100["swap_top_replicas"] = check_k8(
                search_mod, rec.calls["swap_top_replicas"][0][0],
                f"{shapes_100} first swap round")
        del rec

    # -- 3. fused main path ----------------------------------------------------
    with Phase("fused 100/10k main path"):
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        t0 = time.time()
        final, result = opt.optimizations(state, meta,
                                          goals=goals_by_priority(cfg))
        torch.cuda.synchronize()
        steady_100 = time.time() - t0
        launches_100 = dict(kernels.LAUNCHES)
        rounds_100 = solve_summary(f"fused steady solve 100/10k ({card})",
                                   result, steady_100)
        print(f"violated before: {result.violated_goals_before}")
        print(f"violated after: {result.violated_goals_after}")
        print(f"launches on the fused steady solve: {launches_100}")
        loop_100 = loop_summary("fused steady 100/10k",
                                opt.last_loop_stats(), steady=True)
        if final.assignment.device.type != "cuda":
            fail("final state is not on the card")
        if [g.name for g in result.goal_results
                if g.is_hard and not g.succeeded]:
            fail("fused 100/10k: hard goals failed")
        if not result.balancedness_after > result.balancedness_before:
            fail("balancedness did not rise")
        if not result.proposals:
            fail("no proposals")
        for name in Recorder.KEYS:
            if launches_100.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the fused path")
        check_round_launches(launches_100, loop_100, "fused 100/10k")
        for name in lines_100:
            lines_100[name]["launches"] = launches_100.get(name, 0)
        busy_100 = profile_solve(opt, state, meta, goals_by_priority(cfg),
                                 steady_100)
        same_runs = torch.equal(warm_final.assignment, final.assignment) \
            and torch.equal(warm_final.leader_slot, final.leader_slot)
        print(f"info: two card runs at 100/10k gave identical assignments: "
              f"{same_runs}")
        s_host, m_host = random_cluster(**SIZE, dist=Dist.EXPONENTIAL,
                                        device="cpu")
        f_host, r_host = GoalOptimizer(cfg, device="cpu").optimizations(
            s_host, m_host)
        same_host = torch.equal(final.assignment.cpu(), f_host.assignment) \
            and torch.equal(final.leader_slot.cpu(), f_host.leader_slot)
        print(f"info: 100/10k card vs CPU assignments equal: {same_host}; "
              f"rounds card {rounds_100} cpu "
              f"{sum(g.rounds for g in r_host.goal_results)}; proposals card "
              f"{len(result.proposals)} cpu {len(r_host.proposals)}")

    # -- 4. fused small reference: card against CPU ----------------------------
    with Phase("fused 16/512 card against CPU"):
        s_cuda, m_cuda = random_cluster(**SMALL, dist=Dist.EXPONENTIAL,
                                        device=dev)
        s_cpu, m_cpu = random_cluster(**SMALL, dist=Dist.EXPONENTIAL,
                                      device="cpu")
        f_cuda, r_cuda = opt.optimizations(s_cuda, m_cuda)
        f_cpu, r_cpu = GoalOptimizer(cfg, device="cpu").optimizations(
            s_cpu, m_cpu)
        same_small = torch.equal(f_cuda.assignment.cpu(), f_cpu.assignment) \
            and torch.equal(f_cuda.leader_slot.cpu(), f_cpu.leader_slot)
        print(f"16/512 card vs CPU assignments equal: {same_small}; "
              f"balancedness card {r_cuda.balancedness_after:.4f} "
              f"cpu {r_cpu.balancedness_after:.4f}")
        if (r_cuda.violated_goals_before != r_cpu.violated_goals_before
                or r_cuda.violated_goals_after != r_cpu.violated_goals_after
                or r_cuda.balancedness_after != r_cpu.balancedness_after):
            fail("16/512: the card and the CPU disagree on the violated "
                 "goals")
        if not same_small or len(r_cuda.proposals) != len(r_cpu.proposals):
            fail("16/512: the card's assignment differs from the CPU's")

    refs = load_reference_outcomes()
    pinned_fields = OUTCOME_FIELDS + ("num_proposals",)

    last_final = {}

    def bounded_solve(ref_name, conf, label, rec=None):
        """A solve of a reference entry's fixture with its goal chain (the
        default without one) and options."""
        ref = refs[ref_name]
        st, mt = build_fixture(ref, dev)
        bopt = GoalOptimizer(CruiseControlConfig(conf), device="cuda")
        goals = [ALL_GOALS[g]() for g in ref["chain"]] \
            if "chain" in ref else None
        options = OptimizationOptions(**{
            k: last_broker_ids(ref, v)
            for k, v in ref.get("options", {}).items()})
        torch.cuda.synchronize()
        t0 = time.time()
        fin, res = bopt.optimizations(st, mt, goals, options)
        torch.cuda.synchronize()
        wall = time.time() - t0
        last_final["state"] = fin
        rounds = solve_summary(label, res, wall)
        direct = [(d["direct_moves"], d["direct_sweeps"])
                  for d in bopt.last_direct_stats()] \
            if conf.get("solver.direct.assignment.enabled") else None
        got = outcome(fin.assignment.cpu().numpy(),
                      fin.leader_slot.cpu().numpy(), res,
                      bopt.last_dispatch_stats(), direct)
        return bopt, st, mt, res, got, wall, rounds

    # -- 5. bounded path 1k/100k, dispatch pinned -------------------------------
    with Phase("bounded 1k/100k pinned: warm-up and main path"):
        healthy = refs["1k_100k"]
        wanted = {
            # select_batch(state, deltas, score, layout, m, extra_last_col,
            # tail)
            "select_batch": lambda *a, **kw:
                sum(r for r, _c in a[3]) == CAP_ROWS and a[4] == CAP_M,
            # apply_deltas_to_agg(agg, sub, sel, pot_delta, lbi_delta)
            "apply_deltas": lambda *a, **kw: a[2].shape[0] == CAP_M,
            # select_sources(state, source_score, weight, num_sources)
            "select_sources": lambda *a, **kw: a[3] == CAP_M,
            # score_grid(..., spec, ...) on the wide grid
            "score_grid": lambda *a, **kw: a[8].cand_p.shape[0] == CAP_M,
            # leadership_sources(state, source_score, weight, num_sources)
            "select_leadership": lambda *a, **kw: a[3] == CAP_M,
        }
        rec = Recorder(chain_mod, search_mod, wanted)
        warm_opt, _s, _m, warm_b, _g, warm_b_s, _r = bounded_solve(
            "1k_100k", healthy["config"], "bounded warm-up solve 1k/100k")
        rec.restore()
        warm_loop_1k = loop_summary("bounded warm-up 1k/100k",
                                    warm_opt.last_loop_stats())
        for key in wanted:
            if key not in rec.picked:
                fail(f"the 1k/100k warm-up never reached {key} at the cap")
        check_k6_goals(sg_mod, k6_mismatches, rec, "1k/100k", k6_held)
        check_k3_goals(search_mod, rec, "1k/100k", k3_held)
        check_k7_goals(slot_mod, rec, "1k/100k", k7_held)
        if not rec.calls["swap_top_replicas"]:
            fail("the 1k/100k warm-up never ran a swap round")
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        bopt, b_state, b_meta, res_b, got_b, steady_1k, rounds_1k = \
            bounded_solve("1k_100k", healthy["config"],
                          f"bounded steady solve 1k/100k ({card})")
        launches_1k = dict(kernels.LAUNCHES)
        print(f"launches on the bounded steady solve: {launches_1k}")
        loop_1k = loop_summary("bounded steady 1k/100k",
                               bopt.last_loop_stats(), steady=True)
        for name in Recorder.KEYS:
            if launches_1k.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the bounded path")
        check_round_launches(launches_1k, loop_1k, "bounded 1k/100k")
        outcome_check("1k/100k pinned", got_b, healthy, pinned_fields, res_b)
        # stats_before / stats_after against cluster_stats on the CPU.
        final_b = last_final["state"]
        for which, got_stats, st_b in (
                ("stats_before", res_b.stats_before, b_state),
                ("stats_after", res_b.stats_after, final_b)):
            want_stats = cluster_stats(st_b.to("cpu"))
            for f in dataclasses.fields(want_stats):
                a = getattr(got_stats, f.name).cpu()
                w = getattr(want_stats, f.name)
                if not torch.equal(a.view(torch.int32) if a.is_floating_point()
                                   else a, w.view(torch.int32)
                                   if w.is_floating_point() else w):
                    fail(f"1k/100k pinned: {which}.{f.name} differs from "
                         f"cluster_stats on the CPU ({a} vs {w})")
        print("1k/100k pinned: stats_before and stats_after bitwise equal "
              "to cluster_stats on the CPU")
        del final_b
        spec = speculative_cost(chain_mod, bounded_solve, healthy,
                                pinned_fields, steady_1k)

    # -- 6. drain-50 ------------------------------------------------------------
    with Phase("bounded 1k/100k drain-50 pinned"):
        drain = refs["1k_100k_drain50"]
        # The drain's blocks share phase 5's graph keys. Dropped, they are
        # captured again, and the recorder sees the eager round before
        # each capture (the replays of cached graphs run nothing it sees).
        chain_mod.clear_graphs()
        rec_d = Recorder(chain_mod, search_mod)
        try:
            warm_d_opt, *_x, res_wd, got_wd, warm_d_s, _r = bounded_solve(
                "1k_100k_drain50", drain["config"],
                "bounded warm-up solve 1k/100k drain-50")
        finally:
            rec_d.restore()
        outcome_check("1k/100k drain-50 warm-up", got_wd, drain,
                      pinned_fields, res_wd)
        check_k7_goals(slot_mod, rec_d, "1k/100k drain-50", k7_held)
        loop_summary("bounded warm-up drain-50", warm_d_opt.last_loop_stats())
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        d_opt, *_x, res_d, got_d, drain_s, _r = bounded_solve(
            "1k_100k_drain50", drain["config"],
            f"bounded steady solve 1k/100k drain-50 ({card})")
        launches_drain = dict(kernels.LAUNCHES)
        print(f"launches on the drain-50 solve: {launches_drain}")
        for name in Recorder.KEYS:
            if launches_drain.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the drain-50 path")
        outcome_check("1k/100k drain-50 pinned", got_d, drain, pinned_fields,
                      res_d)
        loop_drain = loop_summary("bounded steady drain-50",
                                  d_opt.last_loop_stats(), steady=True)
        check_round_launches(launches_drain, loop_drain, "drain-50")
        # K7's count on the first move round of the drain (its first
        # goal's, offline replicas present) held to K1's offline twin; its
        # state is K1's offline mode's direct input in phase 8.
        drain_k7 = next((a for (_g, override), a in rec_d.k7_calls().items()
                         if override), None)
        if drain_k7 is None:
            fail("the drain-50 solve never ran a move round with the "
                 "offline override")
        check_k7(slot_mod, drain_k7, "1k/100k drain-50 first move round",
                 want_offline=True)
        check_k3(search_mod, rec_d.calls["select_batch"][0],
                 "1k/100k drain-50 first round", timed=False)
        drain_offline_state = drain_k7[1]
        del drain_k7
        drain_k2_args, _ = rec_d.calls["select_sources"][0]
        drain_lead_args, _ = rec_d.calls["select_leadership"][0]
        del rec_d

    # -- 7. default config (adaptive dispatch) ---------------------------------
    with Phase("bounded 1k/100k default config"):
        from torch.profiler import ProfilerActivity, profile
        goal_index = [g.name for g in goals_by_priority(cfg)] \
            .index(PROFILED_GOAL)
        orig_goal = opt_mod.optimize_goal_in_chain
        busy = {}

        def profiled_goal(st, chain, index, *args, **kwargs):
            if index != goal_index or busy:
                return orig_goal(st, chain, index, *args, **kwargs)
            torch.cuda.synchronize()
            captures = chain_mod.LOOP_STATS["captures"]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                out = orig_goal(st, chain, index, *args, **kwargs)
                torch.cuda.synchronize()
                wall = time.time() - t0
            busy["captures"] = chain_mod.LOOP_STATS["captures"] - captures
            avgs = [e for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")]
            busy.update(wall=wall, rounds=out[1]["rounds"],
                        busy=sum(_dev_us(e, True) for e in avgs) / 1e6,
                        ops=sum(e.count for e in avgs))
            # K2's kernels without the memset name, which other ops share.
            for kname, knames in (("k4", K4_KERNELS), ("k1", K1_KERNELS),
                                  ("k2", K2_KERNELS[:-1]),
                                  ("k6", K6_KERNELS)):
                busy[f"{kname}_s"] = sum(
                    _dev_us(e, True) for e in avgs
                    if any(n in e.key for n in knames)) / 1e6
            top = sorted(avgs, key=lambda e: _dev_us(e, True),
                         reverse=True)[:8]
            busy["top"] = [(e.key[:90], e.count, _dev_us(e, True) / 1e3)
                           for e in top]
            return out

        default_opt = GoalOptimizer(cfg, device="cuda")
        d_state, d_meta = build_fixture(healthy, dev)
        # The adaptive budgets reach the 64-round aggregate refresh, so
        # the first solve captures each goal's refresh variant.
        t0 = time.time()
        default_opt.optimizations(d_state, d_meta)
        torch.cuda.synchronize()
        print(f"default-config warm-up solve 1k/100k: "
              f"{time.time() - t0:.3f} s")
        loop_summary("default-config warm-up", default_opt.last_loop_stats())
        opt_mod.optimize_goal_in_chain = profiled_goal
        try:
            t0 = time.time()
            default_opt.optimizations(d_state, d_meta)
            torch.cuda.synchronize()
        finally:
            opt_mod.optimize_goal_in_chain = orig_goal
        print(f"default-config second solve 1k/100k (its {PROFILED_GOAL} "
              f"pass profiled, the trace's processing included): "
              f"{time.time() - t0:.3f} s")
        loop_summary("default-config second solve",
                     default_opt.last_loop_stats(), steady=True)
        if busy["captures"]:
            fail(f"the profiled {PROFILED_GOAL} pass captured graphs")
        print(f"profile: {PROFILED_GOAL} pass of the second solve: "
              f"{busy['wall']:.3f} s, {busy['rounds']} rounds, device busy "
              f"{busy['busy']:.3f} s = {busy['busy'] / busy['wall']:.1%} of "
              f"its wall, {busy['ops']} device ops (profiler on)")
        print(f"profile: K4 apply_deltas {busy['k4_s']:.3f} s = "
              f"{busy['k4_s'] / busy['busy']:.1%}, K1 full mode "
              f"{busy['k1_s']:.3f} s = {busy['k1_s'] / busy['busy']:.1%}, "
              f"K2 select_sources {busy['k2_s']:.3f} s = "
              f"{busy['k2_s'] / busy['busy']:.1%}, K6 score_grid (both modes) "
              f"{busy['k6_s']:.3f} s = {busy['k6_s'] / busy['busy']:.1%} of "
              "that pass's device time")
        for key, count, dev_ms in busy.pop("top"):
            print(f"  device {dev_ms:9.2f} ms  calls {count:6d}  {key}")
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        fin, res_a = default_opt.optimizations(d_state, d_meta)
        torch.cuda.synchronize()
        default_s = time.time() - t0
        launches_default = dict(kernels.LAUNCHES)
        solve_summary(f"default-config steady solve 1k/100k ({card})",
                      res_a, default_s)
        stats_a = default_opt.last_dispatch_stats()
        print(f"default-config dispatches: {stats_a}; launches: "
              f"{launches_default}")
        loop_default = loop_summary("default-config steady 1k/100k",
                                    default_opt.last_loop_stats(),
                                    steady=True)
        check_round_launches(launches_default, loop_default,
                             "default config 1k/100k")
        got_a = outcome(fin.assignment.cpu().numpy(),
                        fin.leader_slot.cpu().numpy(), res_a, stats_a)
        outcome_check("1k/100k default config", got_a, healthy,
                      OUTCOME_FIELDS, res_a)

    # -- 8. kernels at the bounded path's shapes --------------------------------
    shapes_1k = "1k/100k"
    with Phase("kernels at the bounded path's shapes"):
        (k1_state, k1_topics), _ = rec.calls["segment_reduce"][0]
        err = check_k1(agg_mod, k1_state, k1_topics, shapes_1k)
        check_k1_offline(agg_mod, drain_offline_state,
                         f"{shapes_1k} drain-50 entry")
        adv_agg = rec.picked["apply_deltas"][0][0]
        adv_line = check_k4(
            agg_mod, ((adv_agg, *k4_adversarial_batch(
                adv_agg.broker_load.shape[0], adv_agg.topic_counts.shape[0],
                dev, seed=3)), {}), f"{shapes_1k} adversarial")
        lines = {
            "segment_reduce": k1_line(agg_mod, k1_state, k1_topics, err,
                                      shapes_1k),
            "segment_reduce_offline": k1_offline_line(
                agg_mod, drain_offline_state, f"{shapes_1k} drain-50 entry"),
            "select_sources": check_k2(
                cand_mod, rec.picked["select_sources"][0],
                f"{shapes_1k} deficit-sized"),
            "select_sources_drain": check_k2(
                cand_mod, drain_k2_args,
                f"{shapes_1k} drain-50 first call (offline replicas at "
                "1e30)"),
            "select_batch": check_k3(search_mod,
                                     rec.picked["select_batch"],
                                     f"{shapes_1k} cap"),
            "apply_deltas": check_k4(agg_mod, rec.picked["apply_deltas"],
                                     f"{shapes_1k} cap")}
        lines["score_grid"] = check_k6(
            sg_mod, k6_mismatches, {"grid": rec.picked["score_grid"][0]},
            f"{shapes_1k} wide cap", timed=True)
        lines["slot_weights"] = check_k7(
            slot_mod, rec.calls["slot_weights"][0][0], shapes_1k, timed=True)
        lines["select_leadership"] = check_k2_leadership(
            cand_mod, rec.picked["select_leadership"][0],
            f"{shapes_1k} cap")
        lines["select_leadership_drain"] = check_k2_leadership(
            cand_mod, drain_lead_args, f"{shapes_1k} drain-50 first call "
            "(offline leaders at 1e30)")
        k8_state = rec.calls["swap_top_replicas"][0][0][0]
        lines["swap_top_replicas"] = check_k8(
            search_mod, rec.calls["swap_top_replicas"][0][0],
            f"{shapes_1k} first swap round")
        for case, w, src_b, dst_b in k8_crafted_cases(k8_state, seed=8):
            check_k8(search_mod, (k8_state, w, src_b, dst_b, 4),
                     f"{shapes_1k}, {case}", timed=False)
        del rec, k8_state

    # -- 9. K1, K2 and K4 at 7k/1M -----------------------------------------------
    shapes_7k = "7k/1M"
    with Phase("K1, K2 and K4 at 7k/1M"):
        big, big_meta = random_cluster(**BIG, dist=Dist.EXPONENTIAL,
                                       device=dev)
        # The last 50 brokers DEAD, so K1's offline mode has real input.
        b_big = big.num_brokers
        big = set_broker_state(big, torch.arange(b_big - 50, b_big),
                               BrokerState.DEAD)
        torch.cuda.synchronize()
        err = check_k1(agg_mod, big, big_meta.num_topics, shapes_7k)
        check_k1_offline(agg_mod, big, f"{shapes_7k}, 50 brokers DEAD")
        lines_7k = {
            "segment_reduce": k1_line(agg_mod, big, big_meta.num_topics, err,
                                      shapes_7k),
            "segment_reduce_offline": k1_offline_line(
                agg_mod, big, f"{shapes_7k}, 50 brokers DEAD")}
        big_agg = agg_mod.compute_agg(big, big_meta.num_topics)
        lines_7k["apply_deltas"] = check_k4(
            agg_mod, ((big_agg, *k4_drain_batch(big, seed=5)), {}),
            f"{shapes_7k} drain, 50 brokers DEAD")
        del big_agg
        score, weight = k2_round_inputs(big, big_meta.num_topics)
        lines_7k["select_sources"] = check_k2(
            cand_mod, (big, score, weight, CAP_M),
            f"{shapes_7k}, 50 brokers DEAD, round inputs (offline replicas "
            "at 1e30)")
        lines_7k["select_leadership"] = check_k2_leadership(
            cand_mod, (big, score, weight, CAP_M),
            f"{shapes_7k}, 50 brokers DEAD, round inputs (offline leaders "
            "at 1e30)")
        for case, w, src_b, dst_b in k8_crafted_cases(big, seed=9):
            check_k8(search_mod, (big, w, src_b, dst_b, 4),
                     f"{shapes_7k}, {case}", timed=False)
        # K7 on one goal of each weight family (the override and the count
        # where the goal moves replicas; the count must see offline
        # replicas), held to its twin and timed.
        big_derived = compute_derived(big)
        k7_dead = []
        for family in K7_FAMILY_GOALS:
            g = k7_family_goal(family, b_big)
            aux = search_mod.goal_aux(g, big, big_derived,
                                      BalancingConstraint(),
                                      big_meta.num_topics)
            override = not g.leadership_only
            k7_dead.append(check_k7(
                slot_mod, (g, big, big_derived, BalancingConstraint(), aux,
                           big_meta.num_topics, override),
                f"{shapes_7k}, 50 brokers DEAD", timed=True,
                want_offline=override))
            del aux
        del big_derived
        score, weight = k2_round_inputs(big, big_meta.num_topics,
                                        offline_override=False)
        lines_7k["select_sources_disk"] = check_k2(
            cand_mod, (big, score, weight, CAP_M),
            f"{shapes_7k}, DiskUsageDistributionGoal's weights alone")
        del big, score, weight
        k2_lines = [lines_100["select_sources"], lines["select_sources"],
                    lines.pop("select_sources_drain"),
                    lines_7k["select_sources"],
                    lines_7k.pop("select_sources_disk")]
        k2_launches = {ln["shape"]: ln["graph_launches_per_call"]
                       for ln in k2_lines}
        print(f"K2 launches per call (CUDA graph nodes): {k2_launches}")
        if len(set(k2_launches.values())) != 1:
            fail("K2's launch count per call depends on the shape")

    # -- 10. the 7k/1M solve ------------------------------------------------------
    with Phase("bounded 7k/1M pinned: warm-up and main path"):
        ref_7k = refs["7k_1m"]
        # K3 at its cap on this path's inputs: the targeted column is off
        # at 1M partitions (extra_last_col=False), a branch no other
        # phase reaches.
        k3_ms = []

        def k3_at_cap(*a, **kw):
            k3_ms.append(a[4])
            return a[4] == CAP_M

        rec_7k = Recorder(chain_mod, search_mod, {
            "select_batch": k3_at_cap,
            "score_grid": lambda *a, **kw: a[8].cand_p.shape[0] == CAP_M})
        try:
            warm_7k_opt, *_x, res_w7, got_w7, warm_7k_s, _r = bounded_solve(
                "7k_1m", ref_7k["config"], "bounded warm-up solve 7k/1M")
        finally:
            rec_7k.restore()
        outcome_check("7k/1M warm-up", got_w7, ref_7k, pinned_fields, res_w7)
        warm_loop_7k = loop_summary("bounded warm-up 7k/1M",
                                    warm_7k_opt.last_loop_stats())
        del res_w7
        if "select_batch" not in rec_7k.picked:
            fail(f"the 7k/1M warm-up never reached K3 at m={CAP_M} "
                 f"(largest m {max(k3_ms, default=0)})")
        k3_call = rec_7k.picked.pop("select_batch")
        for key in Recorder.K6_KEYS:
            if key not in rec_7k.picked:
                fail(f"the 7k/1M warm-up never reached {key} at the cap")
        lines_7k["score_grid"] = check_k6(
            sg_mod, k6_mismatches,
            {"grid": rec_7k.picked.pop("score_grid")[0]},
            f"{shapes_7k} cap, targeted column off", timed=True)
        check_k6_goals(sg_mod, k6_mismatches, rec_7k, shapes_7k, k6_held)
        check_k3_goals(search_mod, rec_7k, shapes_7k, k3_held)
        check_k7_goals(slot_mod, rec_7k, shapes_7k, k7_held, k7_families)
        lines_7k["slot_weights"] = check_k7(
            slot_mod, rec_7k.calls["slot_weights"][0][0], shapes_7k,
            timed=True)
        if not rec_7k.calls["swap_top_replicas"]:
            fail("the 7k/1M warm-up never ran a swap round")
        lines_7k["swap_top_replicas"] = check_k8(
            search_mod, rec_7k.calls["swap_top_replicas"][0][0],
            f"{shapes_7k} first swap round")
        # No sort or top-k over P*S keys in a move or a swap round.
        sort_keys = {}
        for key in Recorder.BODY_KEYS:
            if not rec_7k.calls[key]:
                fail(f"the 7k/1M warm-up never ran {key}")
            b_args, b_kwargs = rec_7k.calls[key][0]
            sort_keys[key] = largest_sort_input(
                lambda: getattr(chain_mod, key)(*b_args, **b_kwargs))
        del b_args, b_kwargs
        n_slots = BIG["num_partitions"] * BIG["rf"]
        print(f"7k/1M: the largest sort or top-k input of one move round "
              f"{sort_keys['_chain_round_body']:,} keys, of one swap round "
              f"{sort_keys['_chain_swap_body']:,} keys (P*S = {n_slots:,})")
        if max(sort_keys.values()) >= n_slots:
            fail("a round at 7k/1M still sorts P*S keys")
        del rec_7k
        k3_args, k3_kwargs = k3_call
        extra = k3_kwargs.get("extra_last_col",
                              k3_args[5] if len(k3_args) > 5 else False)
        if extra:
            fail("K3 at 7k/1M ran with the targeted column on")
        lines_7k["select_batch"] = check_k3(
            search_mod, k3_call,
            f"{shapes_7k} cap, targeted column off")
        del k3_call, k3_args, k3_kwargs
        torch.cuda.synchronize()
        kernels.LAUNCHES.clear()
        opt_7k, st_7k, meta_7k, res_7k, got_7k, steady_7k, rounds_7k = \
            bounded_solve("7k_1m", ref_7k["config"],
                          f"bounded steady solve 7k/1M ({card})")
        launches_7k = dict(kernels.LAUNCHES)
        print(f"launches on the 7k/1M steady solve: {launches_7k}")
        for name in Recorder.KEYS:
            if launches_7k.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched on the 7k/1M path")
        outcome_check("7k/1M pinned", got_7k, ref_7k, pinned_fields, res_7k)
        print(f"7k/1M digests: assignment {got_7k['assignment_sha256']} "
              f"(reference {ref_7k['assignment_sha256']}), leader slots "
              f"{got_7k['leader_slot_sha256']} (reference "
              f"{ref_7k['leader_slot_sha256']})")
        loop_7k = loop_summary("bounded steady 7k/1M",
                               opt_7k.last_loop_stats(), steady=True)
        check_round_launches(launches_7k, loop_7k, "7k/1M")
        # The swap round's grid at 1M (search.swap_grid, its top-j by K8;
        # the twin's two stable sorts over [8, P*S] keys beside it), on
        # DiskUsageDistributionGoal's inputs at the solve's entry state.
        derived, src, dst, weight = swap_grid_inputs(st_7k,
                                                     meta_7k.num_topics)
        k_b = 8
        src_b = torch.topk(torch.where(src > 0, src, torch.full(
            (), float("-inf"), device=dev)), k_b).indices
        dst_b = torch.topk(dst, k_b).indices
        # Eagerly the grid's ~150 small ops are host-bound; the device
        # time (every kernel of a call, profiler) is what a replayed graph
        # spends.
        swap_grid_ms = cuda_ms(lambda: search_mod.swap_grid(
            st_7k, derived, src, dst, weight), 5)
        swap_grid_dev_ms, swap_grid_ops = device_ms(
            lambda: search_mod.swap_grid(st_7k, derived, src, dst, weight),
            [""], 5)
        swap_sorts_ms = cuda_ms(lambda: (
            search_mod._per_broker_top_replicas(st_7k, weight, src_b, 4,
                                                largest=True),
            search_mod._per_broker_top_replicas(st_7k, weight, dst_b, 4,
                                                largest=False)), 5)
        print(f"swap grid at 7k/1M ({card}): {swap_grid_ms:.3f} ms a swap "
              f"round by CUDA events (host-bound eagerly), device "
              f"{swap_grid_dev_ms} ms in {swap_grid_ops} device ops; the "
              f"twin of its top-j (two stable sorts over [8, "
              f"{st_7k.num_partitions * 3}] keys) {swap_sorts_ms:.3f} ms")
        del derived, src, dst, weight, st_7k

    # -- 11. the JBOD disk path at 7k/1M ----------------------------------------
    with Phase("JBOD 7k/1M: rebalance_disk and remove_disks"):
        jb_state, _jb_meta = build_fixture(refs["7k_1m_rebalance_disk"], dev)
        jb_arrays = cluster_to_numpy(jb_state)
        disk_paths = {}

        def disk_path(ref_name, goal, label):
            """Warm-up call, then the main path: violations, optimize,
            violations, launch counts reset just before and read just
            after; held to the reference entry."""
            ref = refs[ref_name]
            before = entry_disks(ref, jb_arrays)
            disks0 = disks_mod.disks_from_numpy(before, dev)
            goal.optimize(jb_state, disks0)
            torch.cuda.synchronize()
            kernels.LAUNCHES.clear()
            t0 = time.time()
            v0 = goal.violations(jb_state, disks0)
            final = goal.optimize(jb_state, disks0)
            v1 = goal.violations(jb_state, final)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = dict(kernels.LAUNCHES)
            got = disk_outcome(jb_arrays, before,
                               disks_mod.disks_to_numpy(final),
                               v0.cpu().numpy(), v1.cpu().numpy())
            print(f"{label} ({card}): {wall:.3f} s, {got['num_moves']} "
                  f"moves, violation {got['violation_sum_before']:.1f} -> "
                  f"{got['violation_sum_after']:.1f}, "
                  f"{got['replicas_on_dead_dirs']} replicas left on dead "
                  f"dirs (reference {ref['replicas_on_dead_dirs']}), "
                  f"largest broker "
                  f"{disks_mod.LAST_CALL['max_replicas_per_broker']} "
                  f"replicas; launches {launches}")
            for name in ("intra_broker", "intra_broker_load"):
                if launches.get(name, 0) <= 0:
                    fail(f"{label}: kernel {name} was not launched")
            for key in DISK_OUTCOME_FIELDS:
                if got[key] != ref[key]:
                    fail(f"{label}: {key} {got[key]!r} differs from the "
                         f"reference's {ref[key]!r}")
            print(f"{label}: matches the reference on "
                  f"{', '.join(DISK_OUTCOME_FIELDS)}")
            disk_paths[ref_name] = dict(wall_s=wall, launches=launches,
                                        **got)
            return disks0

        band = IntraBrokerDiskUsageDistributionGoal()._band()
        rb_disks = disk_path("7k_1m_rebalance_disk",
                             IntraBrokerDiskUsageDistributionGoal(),
                             "rebalance_disk 7k/1M")
        rm_disks = disk_path("7k_1m_remove_disks",
                             IntraBrokerDiskCapacityGoal(),
                             "remove_disks 7k/1M")
        k5_lines = [
            check_k5(disks_mod, jb_state, rb_disks, band, None,
                     "7k/1M rebalance_disk, D=2"),
            check_k5(disks_mod, jb_state, rm_disks, None, None,
                     "7k/1M remove_disks, D=2, 50 dirs dead")]
        k5_load = k5_load_line(disks_mod, jb_state, rb_disks,
                               "7k/1M, D=2")
        k5_load_line(disks_mod, jb_state, rm_disks,
                     "7k/1M remove_disks, D=2, 50 dirs dead", timed=False)
        del rb_disks, rm_disks
        rp_state, _rp_meta = build_fixture(healthy, dev)
        rp_arrays = cluster_to_numpy(rp_state)
        k5_load_others = []
        for num_disks, goal_band, seed in ((4, band, 4), (8, None, 8)):
            rp_disks, rp_movable = random_placement_disks(
                rp_arrays["assignment"], rp_arrays["partition_mask"],
                rp_arrays["capacity"][:, 3], num_disks, seed)
            rp_disks = disks_mod.disks_from_numpy(rp_disks, dev)
            k5_lines.append(check_k5(
                disks_mod, rp_state, rp_disks,
                goal_band, torch.as_tensor(rp_movable, device=dev),
                f"1k/100k, D={num_disks}, seeded random placement, "
                f"{'band' if goal_band else 'capacity'}, 10% pinned"))
            k5_load_others.append(k5_load_line(
                disks_mod, rp_state, rp_disks,
                f"1k/100k, D={num_disks}, seeded random placement"))
        del rp_state
        # A broker above the balancer's 8,192 replicas: the load mode
        # returns its loads, the balancer raises its limit.
        for num_disks in (2, 8):
            cl, dk = crowded_broker_case(num_disks, seed=num_disks)
            cr_state = cluster_from_numpy(cl, dev)
            cr_disks = disks_mod.disks_from_numpy(dk, dev)
            k5_load_line(disks_mod, cr_state, cr_disks,
                         f"4 brokers, {int((cl['assignment'] == 1).sum())} "
                         f"replicas on broker 1, D={num_disks}", timed=False)
            try:
                disks_mod.balance_intra_broker(cr_state, cr_disks)
            except ValueError as err:
                print(f"K5 balancer on that case raises as it should: {err}")
            else:
                fail("K5's balancer took a broker above 8,192 replicas")
        for case in SENTINEL_CASES:
            cl, dk, mv, case_band = sentinel_case(case)
            check_k5(disks_mod, cluster_from_numpy(cl, dev),
                     disks_mod.disks_from_numpy(dk, dev), case_band,
                     torch.as_tensor(mv, device=dev) if mv is not None
                     else None, f"sentinel case {case}", timed=False)
        for seed in range(40):
            cl, dk, mv, case_band = random_disk_case(
                seed, num_brokers=4 + seed % 5, num_partitions=10 + seed % 30,
                rf=1 + seed % 3, num_disks=2 + seed % 3)
            check_k5(disks_mod, cluster_from_numpy(cl, dev),
                     disks_mod.disks_from_numpy(dk, dev), case_band,
                     torch.as_tensor(mv, device=dev), f"random case {seed}",
                     timed=False)
        for name in K5_EDGE_CASES:
            cl, dk, mv, case_band = k5_edge_case(name)
            check_k5(disks_mod, cluster_from_numpy(cl, dev),
                     disks_mod.disks_from_numpy(dk, dev), case_band,
                     torch.as_tensor(mv, device=dev), f"edge case {name}",
                     timed=False)
        print(f"K5: exact against its twin on the {len(SENTINEL_CASES)} "
              f"sentinel cases, 40 small random cases and the "
              f"{len(K5_EDGE_CASES)} edge cases")
        k5_launches = {ln["shape"]: ln["device_launches_per_call"]
                       for ln in k5_lines}
        print(f"K5 device launches per call: {k5_launches}; load mode "
              f"{k5_load['device_launches_per_call']}")
        if len(set(k5_launches.values())) != 1:
            fail("K5's launch count per call depends on the shape")
        del jb_state

    # -- 12.-14. the goals outside the default chain ---------------------------
    extra_paths = {}
    digest_fields = pinned_fields + ("assignment_sha256",
                                     "leader_slot_sha256")
    for phase, ref_name, label in (
            ("12", "7k_1m_demote", "demote_broker 7k/1M"),
            ("13", "1k_100k_kafka_assigner", "kafka-assigner 1k/100k"),
            ("14", "100_10k_extra_chain", "18-goal chain 100/10k")):
        with Phase(f"{phase}. {label}: warm-up and main path"):
            ref = refs[ref_name]
            chain_mod.clear_graphs()
            rec_x = Recorder(chain_mod, search_mod)
            try:
                warm_opt, *_x, res_w, got_w, warm_s, _r = bounded_solve(
                    ref_name, ref["config"], f"{label} warm-up solve")
            finally:
                rec_x.restore()
            check_k6_goals(sg_mod, k6_mismatches, rec_x, label, k6_held)
            check_k3_goals(search_mod, rec_x, label, k3_held)
            check_k7_goals(slot_mod, rec_x, label, k7_held, k7_families)
            # K2's leadership mode and K8 on the path's first calls.
            if rec_x.calls["select_leadership"]:
                check_k2_leadership(cand_mod,
                                    rec_x.calls["select_leadership"][0][0],
                                    f"{label} first move round", timed=False)
            if rec_x.calls["swap_top_replicas"]:
                check_k8(search_mod, rec_x.calls["swap_top_replicas"][0][0],
                         f"{label} first swap round", timed=False)
            del rec_x
            outcome_check(f"{label} warm-up", got_w, ref, digest_fields,
                          res_w)
            loop_summary(f"{label} warm-up", warm_opt.last_loop_stats())
            torch.cuda.synchronize()
            kernels.LAUNCHES.clear()
            x_opt, *_x, res_x, got_x, steady_s, rounds_x = bounded_solve(
                ref_name, ref["config"], f"{label} steady solve ({card})")
            launches_x = dict(kernels.LAUNCHES)
            print(f"launches on the {label} steady solve: {launches_x}")
            for name in Recorder.KEYS:
                if launches_x.get(name, 0) <= 0:
                    fail(f"kernel {name} was not launched on the {label} "
                         "path")
            outcome_check(label, got_x, ref, digest_fields, res_x)
            print(f"{label}: violated before {res_x.violated_goals_before}, "
                  f"after {res_x.violated_goals_after}")
            loop_x = loop_summary(f"{label} steady", x_opt.last_loop_stats(),
                                  steady=True)
            check_round_launches(launches_x, loop_x, label)
            extra_paths[ref_name] = dict(
                warmup_s=warm_s, steady_s=steady_s, rounds=rounds_x,
                dispatch=got_x["dispatch_stats"], launches=launches_x,
                loop=loop_x)
            del res_w, res_x
            last_final.clear()

    # -- 14a.-14b. the direct-assignment transport ----------------------------
    from cruise_control_tpu_torch.analyzer import direct as direct_mod
    direct_paths = {}
    direct_lines = {}
    for phase, ref_name, label in (
            ("14a", "1k_100k_direct", "direct 1k/100k"),
            ("14b", "7k_1m_direct", "direct 7k/1M")):
        with Phase(f"{phase}. {label}: warm-up, KD1-KD4 and main path"):
            ref = refs[ref_name]
            chain_mod.clear_graphs()
            drec = DirectRecorder(direct_mod)
            try:
                warm_opt, *_x, res_w, got_w, warm_s, _r = bounded_solve(
                    ref_name, ref["config"], f"{label} warm-up solve")
            finally:
                drec.restore()
            outcome_check(f"{label} warm-up", got_w, ref, pinned_fields,
                          res_w)
            direct_outcome_check(f"{label} warm-up", got_w, ref)
            loop_summary(f"{label} warm-up", warm_opt.last_loop_stats())
            held = check_direct_recorded(drec, label)
            print(f"{label}: KD1-KD4 equal to their twins on a CPU copy on "
                  f"{len(held)} recorded calls and each kernel's largest: "
                  f"{held}")
            for goal, entry in drec.entries.items():
                sweep_without_sync(direct_mod, entry, f"{label}, {goal}")
            timed = {kernel: direct_line(
                kernel, call, f"{label}, largest call ({size:,} elements, "
                f"{goal}, {variant})")
                for kernel, (size, goal, variant, call)
                in drec.largest.items()}
            # KD1's position-keyed sort (no second key) has a row of its
            # own: the first of the goal the largest sort was made for.
            sort_goal = drec.largest["direct_sort"][1]
            keyed = drec.calls.get(("direct_sort", sort_goal, "keyed"))
            if keyed is not None:
                timed["direct_sort_keyed"] = direct_line(
                    "direct_sort", keyed, f"{label}, position-keyed sort "
                    f"({keyed[0][0].numel():,} elements, {sort_goal})")
            if phase == "14b":
                # No PyTorch sort, cumsum or searchsorted over P*S in a
                # sweep: KD1-KD4 do that work.
                (st_d, goals_d, index_d, con_d, topics_d, masks_d, *_r), \
                    kw_d = drec.entries[PROFILED_GOAL]
                sweep_fn = direct_mod._sweep_fn(goals_d, index_d)
                biggest = largest_sort_input(lambda: sweep_fn(
                    st_d, goals_d, index_d, con_d, topics_d, masks_d,
                    sweep=1, seed=kw_d["seed"]), DIRECT_FORBIDDEN_OPS)
                n_slots = BIG["num_partitions"] * BIG["rf"]
                print(f"{label}: the largest input of a PyTorch sort, "
                      f"cumsum or searchsorted in one {PROFILED_GOAL} sweep "
                      f"{biggest:,} elements (P*S = {n_slots:,})")
                if biggest >= n_slots:
                    fail(f"{label}: a direct sweep ran a PyTorch sort, "
                         "cumsum or searchsorted over P*S elements")
                del st_d, goals_d, masks_d
            del drec
            torch.cuda.synchronize()
            kernels.LAUNCHES.clear()
            x_opt, *_x, res_x, got_x, steady_s, rounds_x = bounded_solve(
                ref_name, ref["config"], f"{label} steady solve ({card})")
            launches_x = dict(kernels.LAUNCHES)
            print(f"launches on the {label} steady solve: {launches_x}")
            for name in tuple(DIRECT_KERNELS) + Recorder.KEYS:
                if launches_x.get(name, 0) <= 0:
                    fail(f"kernel {name} was not launched on the {label} "
                         "path")
            outcome_check(label, got_x, ref, pinned_fields, res_x)
            direct_outcome_check(label, got_x, ref)
            print(f"{label} digests: assignment {got_x['assignment_sha256']}"
                  f" (reference {ref['assignment_sha256']}), leader slots "
                  f"{got_x['leader_slot_sha256']} (reference "
                  f"{ref['leader_slot_sha256']})")
            loop_x = loop_summary(f"{label} steady", x_opt.last_loop_stats(),
                                  steady=True)
            check_round_launches(launches_x, loop_x, label)
            direct_paths[ref_name] = dict(
                warmup_s=warm_s, steady_s=steady_s, rounds=rounds_x,
                dispatch=got_x["dispatch_stats"], launches=launches_x,
                loop=loop_x,
                direct=[(g["name"], g["direct_moves"], g["direct_sweeps"])
                        for g in got_x["goals"] if g["direct_sweeps"]],
                assignment_equal=got_x["assignment_sha256"]
                == ref["assignment_sha256"],
                leader_equal=got_x["leader_slot_sha256"]
                == ref["leader_slot_sha256"])
            direct_lines[ref_name] = timed
            del res_w, res_x
            last_final.clear()

    # -- 14c. KD3 on one row: a cluster-wide count goal's plan --------------------
    with Phase("14c. KD3 at G = 1"):
        from cruise_control_tpu_torch.testing import kd3_case
        kd3_rows = []
        for b in (1000, 7000):
            call = (tuple(torch.as_tensor(x, device=dev)
                          for x in kd3_case("dense", 1, b, seed=b)), {})
            check_direct("direct_plan", call, f"G = 1, B = {b:,}")
            kd3_rows.append(direct_line(
                "direct_plan", call, f"G = 1, B = {b:,} (one row, as a "
                "cluster-wide count goal plans; dense Poisson-30 counts)"))

    # -- 15. K6 on every goal of the four chains ------------------------------
    with Phase("K6 against its twin on every goal as active"):
        cov_state, cov_meta = random_cluster(**SIZE, dist=Dist.EXPONENTIAL,
                                             device=dev)
        cov_cfg = search_mod.SearchConfig(num_sources=256, num_dests=32,
                                          moves_per_round=64)
        for chain_name in K6_CHAINS:
            chain_goals = k6_goals(chain_name, cov_state.num_brokers)
            for i, g in enumerate(chain_goals):
                if g.name in k6_held:
                    continue
                check_k6(sg_mod, k6_mismatches, k6_round_inputs(
                    cov_state, chain_goals, i, cov_meta.num_topics, cov_cfg),
                    f"{shapes_100} {chain_name} chain, {g.name} active")
                k6_held.setdefault(g.name, []).append(
                    f"{shapes_100} {chain_name} chain (direct round)")
                # k6_mismatches also held that round's K3 call, with the
                # recheck, to the composition.
                k3_held.setdefault(g.name, []).append(
                    f"{shapes_100} {chain_name} chain (direct round)")
        for goal, where in sorted(k6_held.items()):
            print(f"K6 bitwise equal to its twin, {goal} active: "
                  f"{', '.join(where)}")
        for goal, where in sorted(k3_held.items()):
            print(f"K3 with the joint recheck and the move cap equal to the "
                  f"composition, {goal} active: {', '.join(where)}")
        # K7 on every goal no solve above gave a round, with and without
        # the offline override.
        cov_state = set_broker_state(cov_state, torch.arange(95, 100),
                                     BrokerState.DEAD)
        cov_derived = compute_derived(cov_state)
        cov_goals = {g.name: g for chain_name in K6_CHAINS
                     for g in k6_goals(chain_name, cov_state.num_brokers)}
        for name in sorted(ALL_GOALS):
            if name in k7_held:
                continue
            g = cov_goals.get(name) or ALL_GOALS[name]()
            aux = search_mod.goal_aux(g, cov_state, cov_derived,
                                      BalancingConstraint(),
                                      cov_meta.num_topics)
            family = g.weight_args(cov_state, cov_derived,
                                   BalancingConstraint(), aux).family.name
            for override in (True, False):
                timed = override and family not in k7_families
                line = check_k7(slot_mod, (g, cov_state, cov_derived,
                                           BalancingConstraint(), aux,
                                           cov_meta.num_topics, override),
                                f"{shapes_100}, 5 brokers DEAD, {name} "
                                "active", timed)
                if timed:
                    k7_families[family] = line
            k7_held.setdefault(name, []).append(
                f"{shapes_100}, 5 brokers DEAD (direct call)")
        for goal, where in sorted(k7_held.items()):
            print(f"K7 bitwise equal to its twin, {goal} active: "
                  f"{', '.join(where)}")
        if sorted(k7_held) != sorted(ALL_GOALS):
            fail("K7 was not held to its twin on every goal")
        missing = {f.name for f in slot_mod.FAMILY_ARRAYS} - set(k7_families)
        if missing:
            fail(f"K7 was not timed on the weight families {sorted(missing)}")
        del cov_state, cov_derived

    # -- 16. result lines -------------------------------------------------------
    replaces = {
        "segment_reduce": ("cruise_control_tpu_torch/csrc/segment_reduce.cu",
                           "cruise_control_tpu/analyzer/agg.py:70"),
        "segment_reduce_offline": (
            "cruise_control_tpu_torch/csrc/segment_reduce.cu",
            "cruise_control_tpu/analyzer/chain.py:237"),
        "select_sources": ("cruise_control_tpu_torch/csrc/select_sources.cu",
                           "cruise_control_tpu/analyzer/candidates.py:181"),
        "select_batch": ("cruise_control_tpu_torch/csrc/select_batch.cu",
                         "cruise_control_tpu/analyzer/search.py:89"),
        "apply_deltas": ("cruise_control_tpu_torch/csrc/apply_deltas.cu",
                         "cruise_control_tpu/analyzer/agg.py:98"),
        "score_grid": ("cruise_control_tpu_torch/csrc/score_grid.cu",
                       "cruise_control_tpu/analyzer/chain.py:275"),
        "slot_weights": ("cruise_control_tpu_torch/csrc/slot_pass.cu",
                         "cruise_control_tpu/analyzer/chain.py:146"),
        "select_leadership": (
            "cruise_control_tpu_torch/csrc/select_leadership.cu",
            "cruise_control_tpu/analyzer/candidates.py:315"),
        "swap_top_replicas": ("cruise_control_tpu_torch/csrc/swap_select.cu",
                              "cruise_control_tpu/analyzer/search.py:390"),
    }
    kernel_lines = []
    for name, (source, ref_line) in replaces.items():
        line = dict(name=name, route="cuda", source=source,
                    replaces=ref_line, launches=launches_1k.get(name, 0),
                    launches_fused_100_10k=launches_100.get(name, 0),
                    launches_default_config_1k=launches_default.get(name, 0),
                    launches_drain50_1k=launches_drain.get(name, 0),
                    launches_7k_1m=launches_7k.get(name, 0),
                    **lines[name])
        line["other_shapes"] = (
            [lines_100[name]] if name in lines_100 else []) + (
            [adv_line] if name == "apply_deltas" else []) + (
            k2_lines[2:] if name == "select_sources" else
            [lines.pop("select_leadership_drain"), lines_7k[name]]
            if name == "select_leadership" else
            [lines_7k[name]] if name in lines_7k else [])
        if name == "select_batch":
            # The joint recheck and the move cap run in K3's select kernel
            # (K6's recheck mode launches no more).
            line["also_replaces"] = [
                "cruise_control_tpu/analyzer/chain.py:301",
                "cruise_control_tpu/analyzer/search.py:179"]
        if name == "slot_weights":
            line["families"] = [k7_families[f.name]
                                 for f in slot_mod.FAMILY_ARRAYS]
            line["families_7k_1m_dead50"] = k7_dead
        line["launches_extra_paths"] = {
            k: v["launches"].get(name, 0) for k, v in extra_paths.items()}
        kernel_lines.append(line)
    rb_launches = disk_paths["7k_1m_rebalance_disk"]["launches"]
    rm_launches = disk_paths["7k_1m_remove_disks"]["launches"]
    kernel_lines.append(dict(
        name="intra_broker", route="cuda",
        source="cruise_control_tpu_torch/csrc/intra_broker.cu",
        replaces="cruise_control_tpu/model/disks.py:92",
        launches=rb_launches.get("intra_broker", 0),
        launches_remove_disks=rm_launches.get("intra_broker", 0),
        **k5_lines[0], other_shapes=k5_lines[1:]))
    kernel_lines.append(dict(
        name="intra_broker_load", route="cuda",
        source="cruise_control_tpu_torch/csrc/intra_broker.cu",
        replaces="cruise_control_tpu/model/disks.py:54",
        launches=rb_launches.get("intra_broker_load", 0),
        launches_remove_disks=rm_launches.get("intra_broker_load", 0),
        **k5_load, other_shapes=k5_load_others))
    for name, (source, ref_line) in DIRECT_REPLACES.items():
        kernel_lines.append(dict(
            name=name, route="cuda", source=source, replaces=ref_line,
            launches=direct_paths["7k_1m_direct"]["launches"].get(name, 0),
            launches_1k_100k_direct=direct_paths["1k_100k_direct"][
                "launches"].get(name, 0),
            **direct_lines["7k_1m_direct"][name],
            other_shapes=[direct_lines[entry][key]
                          for entry, key in (
                              ("1k_100k_direct", name),
                              ("7k_1m_direct", f"{name}_keyed"),
                              ("1k_100k_direct", f"{name}_keyed"))
                          if key in direct_lines[entry]]
            + (kd3_rows if name == "direct_plan" else [])))
    print(json.dumps({"kernels": kernel_lines, "card": card,
                      "rounds_per_block": chain_mod.ROUNDS_PER_BLOCK,
                      "fused_100_10k": {"warmup_s": warm_100_s,
                                        "steady_s": steady_100,
                                        "rounds": rounds_100,
                                        "warmup_loop": warm_loop_100,
                                        "loop": loop_100,
                                        "profiled": busy_100},
                      "bounded_1k_100k_pinned": {
                          "warmup_s": warm_b_s, "steady_s": steady_1k,
                          "rounds": rounds_1k,
                          "dispatch": got_b["dispatch_stats"],
                          "warmup_loop": warm_loop_1k, "loop": loop_1k,
                          "speculative": spec},
                      "bounded_1k_100k_drain50_pinned": {
                          "warmup_s": warm_d_s, "steady_s": drain_s,
                          "loop": loop_drain},
                      "bounded_1k_100k_default": {
                          "steady_s": default_s,
                          "rounds": sum(g.rounds for g in
                                        res_a.goal_results),
                          "dispatch": stats_a, "loop": loop_default,
                          "profiled_goal": dict(goal=PROFILED_GOAL, **busy)},
                      "bounded_7k_1m_pinned": {
                          "warmup_s": warm_7k_s, "steady_s": steady_7k,
                          "rounds": rounds_7k,
                          "dispatch": got_7k["dispatch_stats"],
                          "assignment_equal": got_7k["assignment_sha256"]
                          == ref_7k["assignment_sha256"],
                          "leader_equal": got_7k["leader_slot_sha256"]
                          == ref_7k["leader_slot_sha256"],
                          "warmup_loop": warm_loop_7k, "loop": loop_7k,
                          "largest_sort_keys": sort_keys,
                          "swap_grid_ms": swap_grid_ms,
                          "swap_grid_device_ms": swap_grid_dev_ms,
                          "swap_grid_device_ops": swap_grid_ops,
                          "swap_sorts_ms": swap_sorts_ms},
                      "jbod_7k_1m": disk_paths,
                      "extra_chains": extra_paths,
                      "direct": direct_paths,
                      "total_s": time.time() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
