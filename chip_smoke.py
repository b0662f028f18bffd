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

1. Print the card's name and power limit, build the eight CUDA kernel
   libraries (one nvcc per source, all started together) and print the
   build time.
2. Fused path, 100 brokers / 10k partitions / RF 3 / 8 racks
   (``_run_stage``): a warm-up solve (the capture) recording the real
   inputs of the kernels of its rounds (the eager round before each
   capture; a call made while a graph captures holds no values); each
   kernel held against its plain PyTorch twin on those inputs (K1 and K4
   bit for bit against the twin run on a CPU copy, which sums in the
   reference's index order; K2 exact; K3 exact on idx/part_ok/has_earlier
   and bitwise on the pre-deltas; K6, both modes, bitwise against the
   twin on the card on the first round's inputs and on the first round of
   every goal that ran one; K7 bitwise against its twin on every goal's
   first move round and first swap round; K2's leadership mode and K8
   exact on their first calls) and timed with CUDA events and the
   profiler beside the twin, its bound and, where one exists, a single
   PyTorch library call.
3. Fused main path: launch counts reset, one steady solve, counts read;
   every hard goal satisfied, balancedness rose, proposals exist, every
   kernel launched (K1's full and offline modes counted apart; on this
   and every later main path K7 once per move round and per swap round,
   K2's leadership mode once per move round, K8 once per swap round as
   ``last_loop_stats()`` counts them). A profiled solve gives the
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
   to its twin on every goal's first round of the warm-up); whether
   the assignment and leader digests and the dispatch statistics equal
   the reference's, and the first goal whose moves differ, are printed.
   The steady solve's ``stats_before`` and ``stats_after`` must equal
   ``cluster_stats`` run on the CPU on copies of the same states, bit for
   bit. Then the async pump's speculative dispatches are costed: one solve
   with every dispatch timed, and one with
   ``solver.dispatch.async.readback=false`` (no speculative dispatch),
   each held to the same reference.
6. The same fixture with its last 50 brokers DEAD, against its entry: a
   warm-up solve (which records the first call of K1's offline mode for
   phase 8), then a steady solve as a main path of its own (launch counts
   reset and read).
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
   inputs: K3 at its cap, K6 on the wide grid (2,048 source rows) and
   its recheck at m = 2,048, K7 on the first round, K2's leadership mode
   at its cap (k = 2,048) and on drain-50's first call, K8 on the first
   swap round and on crafted tie cases, K4 at m = 2,048 and on an
   adversarial batch (every row leaving broker 0 within topic 0, every
   4th row unselected and naming broker B-1), K1 and K2 at 1k/100k
   (K1's offline mode and K2 also on phase 6's first recorded calls:
   4,971 offline replicas, each weighing 1e30 in K2's input), each
   against its twin as in phase 2, and timed.
9. K1 (full and offline), K2 and K4 at 7,000 brokers / 1M partitions /
   700 topics with the last 50 brokers DEAD: K1 and K4 bitwise against
   their twins on a CPU copy (K4 on 2,048 replicas of the DEAD brokers
   moved to seeded live brokers, every 8th row unselected), K2 exact on
   DiskUsageDistributionGoal's scores and weights as the round body
   builds them (the offline count added to the score, 6,830 offline
   replicas at 1e30) and without that override, K2's leadership mode on
   the same inputs; timed; K8 exact on crafted tie cases. K1's offline
   check fails on an input without offline replicas (an all-zero twin
   output).
10. The bounded solve at 7,000 brokers / 1M partitions / 700 topics
    (``bench.py``'s STAGES (7_000, 1_000_000, 0), the targeted column
    off), pinned dispatch: a warm-up solve (the capture) and a steady
    solve (launch counts reset and read, every kernel launched), each held
    to the ``7k_1m`` reference entry as in phase 5; the digests printed.
    K3 at its cap (m = 2,048) and K6 on its 2,048-source grid and
    m = 2,048 recheck, recorded from the warm-up, with the targeted column
    off, held against their twins as in phase 8 and timed; K6 and K7 also
    on every goal's first round of the warm-up; K7 and K8 timed on the
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
    placements at 1k/100k, on the sentinel-collision fixtures and on 40
    small random ones; each timed beside the twin on the card and its
    bound. K5's device launches per call must be the same at every
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
    steady, held to ``1k_100k_kafka_assigner``.
14. The 18-goal chain at 100/10k (RackAwareDistributionGoal,
    BrokerSetAwareGoal on config/brokerSets.json,
    MinTopicLeadersPerBrokerGoal, then the default chain), pinned, fused:
    warm-up, then steady, held to ``100_10k_extra_chain``. In 12-14 K6
    and K7 are held to their twins on every goal's first round of the
    warm-up.
15. K6 against its twin, both modes bitwise, with every goal of the four
    ``testing.K6_CHAINS`` (all 14 goal families) active that no solve
    above gave a round of: one eager round at 100/10k each; K7 likewise
    on every goal of ``ALL_GOALS`` (all 21) no solve reached, directly
    at 100/10k with 5 brokers DEAD. The goals and where each was held are
    printed.
16. One JSON line describing each kernel, K1's, K5's and K6's two modes
    apart (at the bounded path's shapes, with the other shapes under
    ``other_shapes``, and launches per steady solve of every main path),
    then the device line. Every line carries its device launches per
    call from the profiler (K6's grid mode two, its recheck one, or the
    run fails; each K6 line names the active goal of its round); K2's
    lines also the nodes of a CUDA graph capturing one call, which must
    be the same at every shape, or the run fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
    and not biased low by what was. A loss is printed."""
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
    mine = [e for e in prof.key_averages() if e.count
            and any(n in e.key for n in kernel_names)]
    per_call = {e.key: max(1, round(e.count / reps)) for e in mine}
    total = sum(_dev_us(e, False) / e.count * per_call[e.key] for e in mine)
    records = sum(e.count for e in mine)
    if records != reps * sum(per_call.values()):
        print(f"  profiler trace of {reps} calls holds {records} records "
              f"of the named ops, not {reps * sum(per_call.values())} "
              "(timed per record)")
    return (total / 1e3 if total > 0 else None, sum(per_call.values()))


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
    """A tensor, or a dataclass or namespace of tensors, copied to the
    host."""
    import dataclasses
    import types
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: to_cpu(getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: to_cpu(v)
                                        for k, v in vars(obj).items()})
    return obj.cpu() if obj is not None else None


def snapshot(obj):
    """A recorded argument with every tensor in it cloned: a round's
    inputs may be the round loop's static buffers, which later replays
    overwrite."""
    import dataclasses
    import types

    import torch
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: snapshot(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: snapshot(v)
                                        for k, v in vars(obj).items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(snapshot(x) for x in obj)
    if isinstance(obj, dict):
        return {k: snapshot(v) for k, v in obj.items()}
    return obj


class Recorder:
    """Wraps the kernel wrappers the chain calls and keeps copies of the
    inputs of the first call of each, of the first call that ``wanted``
    (kernel name -> predicate over the call's arguments) picks out and,
    for K6's two modes, of the first call of each active goal."""

    # The kernels every move round launches (checked on every path).
    KEYS = ("segment_reduce", "segment_reduce_offline", "select_sources",
            "select_batch", "apply_deltas", "score_grid",
            "score_grid_recheck", "slot_weights",
            "select_sources_leadership")
    K6_KEYS = ("score_grid", "score_grid_recheck")
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
        self._wrap(chain_mod, "offline_per_broker", "segment_reduce_offline")
        self._wrap(chain_mod, "select_sources", "select_sources")
        self._wrap(search_mod, "select_batch", "select_batch")
        self._wrap(chain_mod, "apply_deltas_to_agg", "apply_deltas")
        self._wrap(chain_mod, "score_grid", "score_grid")
        self._wrap(chain_mod, "recheck", "score_grid_recheck")
        self._wrap(chain_mod, "slot_weights", "slot_weights")
        self._wrap(cand_mod, "leadership_sources", "select_sources_leadership")
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
                # score_grid / recheck(state, derived, constraint, goals,
                # aux_list, active, ...)
                goal_key = (key, args[3][args[5]].name)
                if goal_key not in self.per_goal:
                    self.per_goal[goal_key] = snapshot(args)
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
        """{active goal's name: {"grid": args, "recheck": args}} of the
        goals whose rounds reached both modes."""
        out = {}
        for (key, *rest), args in self.per_goal.items():
            if key not in self.K6_KEYS:
                continue
            goal = rest[0]
            mode = "grid" if key == "score_grid" else "recheck"
            out.setdefault(goal, {})[mode] = args
        return {g: r for g, r in out.items() if len(r) == 2}


def measure(fn, plain_fn, kernel_names, nbytes, ops, library_fn=None,
            reps: int = REPS) -> dict:
    """CUDA-event and profiler times of a kernel's wrapper, its twin's
    time, its bound and the library yardstick's time."""
    bms, bby = bound(nbytes, ops)
    dev_ms, dev_launches = device_ms(fn, kernel_names, reps)
    return dict(ms=cuda_ms(fn, reps), device_ms=dev_ms,
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
K3_KERNELS = ["reduce_rows_kernel", "topk_gather_kernel", "dedupe_kernel",
              "ranks_kernel", "scan_kernel"]
K4_KERNELS = ["carry_copy_kernel", "event_fold_kernel"]
# K5's kernels, the memset of its counts and the copy of the input disks.
K5_KERNELS = ["count_kernel", "scan_kernel", "scatter_kernel",
              "balance_kernel", "fixup_kernel", "Memset (",
              "Memcpy DtoD"]
# K5's load mode: bucket count, scan, scatter, fold.
K5L_KERNELS = ["load_count_kernel", "load_scan_kernel",
               "load_scatter_kernel", "load_fold_kernel"]
# K6's grid mode: the destination panel, then the rows.
K6_KERNELS = {"score_grid": ["panel_kernel", "score_grid_kernel"],
              "score_grid_recheck": ["recheck_kernel"]}
K6_OPS = {"score_grid": 2, "score_grid_recheck": 1}
# K7's kernels and its memsets (the flag, the peak); K2's leadership mode
# (its digit passes share the name of K2's); K8's kernel and the memset of
# its lists.
K7_KERNELS = ["peak_kernel", "weights_kernel", "Memset ("]
K2L_KERNELS = ["digit_kernel", "lead_compact_kernel", "lead_rank_kernel",
               "lead_pad_kernel", "Memset ("]
K8_KERNELS = ["top_replicas_kernel", "Memset ("]


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


def check_k3(search_mod, pre_fields, call, label: str) -> dict:
    """K3 exact on idx/part_ok/has_earlier and bitwise on the
    pre-deltas."""
    import torch
    args, kwargs = call
    got = search_mod.select_batch(*args, **kwargs)
    want = search_mod.select_batch_plain(*args, **kwargs)
    for name, a, b in (("idx", got[0], want[0]), ("part_ok", got[1], want[1]),
                       ("has_earlier", got[3], want[3])):
        if not torch.equal(a, b):
            fail(f"K3 {name} at {label} differs from its twin")
    for name in ("pre_src_load", "pre_dst_load") + pre_fields:
        if not torch.equal(getattr(got[2], name), getattr(want[2], name)):
            fail(f"K3 {name} at {label} is not bitwise equal to its twin")
    layout, m = args[3], args[4]
    rows = sum(r for r, _c in layout)
    kk = min(m, rows)
    score = args[2]
    print(f"K3 select_batch at {label}: ok ({rows} rows, m={kk}, "
          f"{int(got[1].sum())} considered rows; exact, pre-deltas bitwise)")
    nbytes = score.numel() * 4 + kk * (6 * 4 + 4 * 4 + 2 * 4) \
        + kk * (4 + 1 + 1 + 8 * 4 + 9 * 4)
    # What the function needs, not what this kernel does: one compare per
    # score for the per-source reduce, and a sort of the kk picked keys
    # for the dedupe and the grouped positions.
    ops = score.numel() + kk * max(1, math.ceil(math.log2(max(kk, 2))))
    return dict(shape=f"{label}: {rows} rows x {layout}, m={kk}",
                max_abs_err=0.0,
                **measure(lambda: search_mod.select_batch(*args, **kwargs),
                          lambda: search_mod.select_batch_plain(*args,
                                                                **kwargs),
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
          f"{int(rounds.max())}, largest broker {most} replicas; brokers "
          f"without a pick: {len(no_pick['pinned'])} pinned, "
          f"{len(no_pick['empty'])} empty, above a sentinel owner "
          f"{owners}: {blocking}; twin on the CPU {twin_cpu_s:.2f} s)")
    ops = 2 * int((rounds.to(torch.int64) * replicas.to(torch.int64)).sum())
    line = dict(shape=label, max_abs_err=0.0, max_replicas_per_broker=most,
                max_rounds_per_broker=int(rounds.max()), moved=moved,
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


def k6_cost(mode: str, args) -> tuple[int, int, int]:
    """(rows, bytes, f32 operations) one K6 call needs on these inputs:
    each output written once; each input row's own fields, each source
    partition's slots, loads and flags, the per-broker and per-topic
    arrays and the goal table's [B] / [T] / 0-dim arrays read once; two
    cells of a [T, B] plane and one entry of a [P] array a row; ~10
    operations a row for its deltas and ~20 a goal a row."""
    state, derived = args[0], args[1]
    s = state.assignment.shape[1]
    b = state.num_brokers
    goals, prior, active = args[3], args[6], args[5]
    n_goals = sum(1 for i in range(len(goals)) if prior[i] or i == active)
    part_bytes = 4 * s + 4 + 32 + 4 + 1 + 1 + s
    broker_bytes = b * (16 + 4 + 4 + 4 + 4 + 4 + 16)
    if mode == "score_grid":
        spec = args[8]
        (r0, c0), (r1, c1) = spec.layout
        rows, sources = r0 * c0 + r1 * c1, r0 + r1
        row_bytes = 1 + 8 * 4 + 16 + 1 + 1 + 4
    else:
        rows = sources = args[7].valid.shape[0]
        row_bytes = 8 * 4 + 16 + 1 + 32 + 9 * 4 + 1 + 1
    table_bytes = 0
    for i in range(len(goals)):
        if not (prior[i] or i == active):
            continue
        for t in goals[i].score_args(state, derived, args[2],
                                     args[4][i]).arrays:
            if t.dim() == 2:
                table_bytes += rows * 2 * t.element_size()
            elif t.dim() == 1 and t.shape[0] == state.num_partitions:
                table_bytes += sources * t.element_size()
            else:
                table_bytes += t.numel() * t.element_size()
    nbytes = rows * row_bytes + sources * part_bytes + broker_bytes \
        + table_bytes
    return rows, nbytes, rows * (10 + 20 * n_goals)


def check_k6(sg_mod, k6_mismatches, rec: dict, label: str,
             timed: bool = False) -> list[dict]:
    """K6 against its twin on the card on one round's recorded inputs,
    both modes, every output bit for bit; timed beside the twin and the
    bound when ``timed`` (one line a mode)."""
    bad = k6_mismatches(rec)
    if bad:
        fail(f"K6 at {label}: {bad} differ from the twin")
    if not timed:
        return []
    lines = []
    for name, args, fn, plain in (
            ("score_grid", rec["grid"], lambda: sg_mod.score_grid(
                *rec["grid"]), lambda: sg_mod.score_grid_plain(
                *rec["grid"][:11])),
            ("score_grid_recheck", rec["recheck"], lambda: sg_mod.recheck(
                *rec["recheck"]), lambda: sg_mod.recheck_plain(
                *rec["recheck"][:9]))):
        rows, nbytes, ops = k6_cost(name, args)
        goals = args[3]
        active = goals[args[5]].name
        priors = sum(1 for i in range(len(goals)) if args[6][i])
        line = dict(shape=label, rows=rows, active_goal=active,
                    prior_goals=priors, max_abs_err=0.0,
                    **measure(fn, plain, K6_KERNELS[name], nbytes, ops))
        print(f"K6 {name} at {label} ({active} active, {priors} prior): "
              f"{rows} rows, {line['ms']:.4f} ms "
              f"(device {line['device_ms']} in "
              f"{line['device_launches_per_call']} device ops), twin "
              f"{line['plain_ms']:.4f} ms, bound {line['bound_ms']:.5f} ms "
              f"({line['bound_by']}); bitwise equal to the twin")
        if line["device_launches_per_call"] != K6_OPS[name]:
            fail(f"K6 {name} at {label}: {line['device_launches_per_call']} "
                 f"device ops a call, not {K6_OPS[name]}")
        lines.append(line)
    return lines


def check_k6_goals(sg_mod, k6_mismatches, rec: "Recorder", label: str,
                   held: dict) -> None:
    """K6 against its twin on the first recorded round of every goal
    that ran one; their names go into ``held``."""
    for goal, rounds in rec.k6_rounds().items():
        check_k6(sg_mod, k6_mismatches, rounds, f"{label}, {goal} active")
        held.setdefault(goal, []).append(label)


def k7_cost(slot_mod, args) -> tuple[int, int]:
    """(bytes, f32 operations) of one K7 call, from what the goal's weight
    family reads on this call's data: every family reads the assignment,
    the leader slot, the partition mask and the [B] alive flags, and
    writes the weight and the offline mask; the per-topic families read
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


def check_k7(slot_mod, args, label: str, timed: bool = False):
    """K7 bit for bit against its twin on the card (the twin's ops are
    elementwise: exact on any device) on one call's recorded inputs; timed
    beside the twin and the bound of the goal's family when ``timed``."""
    import torch
    goal, override = args[0], args[6]
    got = slot_mod.slot_weights(*args)
    want = slot_mod.slot_weights_plain(*args[:5], override)
    for name, a, b in zip(("weight", "off", "off_any"), got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            fail(f"K7 {name} at {label} ({goal.name}, override "
                 f"{override}) differs from its twin")
    if not timed:
        return None
    nbytes, ops = k7_cost(slot_mod, args)
    family = goal.weight_args(*args[1:5]).family.name
    line = dict(shape=f"{label}, {goal.name} ({family}), override "
                      f"{override}", family=family, max_abs_err=0.0,
                library_call=None,
                **measure(lambda: slot_mod.slot_weights(*args),
                          lambda: slot_mod.slot_weights_plain(
                              *args[:5], override), K7_KERNELS, nbytes, ops))
    print(f"K7 slot_weights at {line['shape']}: {line['ms']:.4f} ms (device "
          f"{line['device_ms']}, {line['device_launches_per_call']} device "
          f"ops a call), twin {line['plain_ms']:.4f} ms, bound "
          f"{line['bound_ms']:.5f} ms ({line['bound_by']}, {nbytes} bytes); "
          "bitwise equal to the twin")
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


def check_k2_leadership(cand_mod, args, label: str) -> dict:
    """K2's leadership mode exact against its twin (values bit for bit,
    partitions, top_k's -inf padding); timed beside the twin, the bound
    and ``torch.topk`` of the masked leader weights (not in the
    reference's tie order)."""
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
    line = dict(shape=f"{label}, k={k}", max_abs_err=0.0,
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


def largest_sort_input(fn) -> int:
    """The most keys any sort or top-k of one eager call of ``fn`` takes
    (the profiler's recorded input shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return max((math.prod(e.input_shapes[0]) for e in prof.events()
                if e.name in SORT_OPS and e.input_shapes
                and e.input_shapes[0]), default=0)


def check_round_launches(launches: dict, loop: dict, label: str) -> None:
    """K7 once per move round and per swap round, K2's leadership mode
    once per move round (as K6's grid) and K8 once per swap round."""
    lead = launches.get("select_sources_leadership", 0)
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
    print(f"{label}: K7 {lead + swap} launches = {lead} move rounds + {swap} "
          f"swap rounds (K2 leadership {lead}, K8 {swap})")


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
        from cruise_control_tpu_torch.analyzer.candidates import PRE_FIELDS
        from cruise_control_tpu_torch.analyzer.constraint import (
            OptimizationOptions,
        )
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
            DISK_OUTCOME_FIELDS, K6_CHAINS, OUTCOME_FIELDS, SENTINEL_CASES,
            build_fixture, disk_outcome, entry_disks, k2_round_inputs,
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
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

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
            "select_batch": check_k3(search_mod, PRE_FIELDS,
                                     rec.calls["select_batch"][0],
                                     shapes_100),
            "apply_deltas": check_k4(agg_mod, rec.calls["apply_deltas"][0],
                                     shapes_100)}
        # K6 on the first round's inputs (timed) and on every goal's first
        # round (goal name -> where K6 was held to its twin).
        k6_held = {}
        lines_100["score_grid"], lines_100["score_grid_recheck"] = check_k6(
            sg_mod, k6_mismatches,
            {"grid": rec.calls["score_grid"][0][0],
             "recheck": rec.calls["score_grid_recheck"][0][0]},
            shapes_100, timed=True)
        check_k6_goals(sg_mod, k6_mismatches, rec, shapes_100, k6_held)
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
        lines_100["select_sources_leadership"] = check_k2_leadership(
            cand_mod, rec.calls["select_sources_leadership"][0][0],
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
        got = outcome(fin.assignment.cpu().numpy(),
                      fin.leader_slot.cpu().numpy(), res,
                      bopt.last_dispatch_stats())
        return bopt, st, mt, res, got, wall, rounds

    # -- 5. bounded path 1k/100k, dispatch pinned -------------------------------
    with Phase("bounded 1k/100k pinned: warm-up and main path"):
        healthy = refs["1k_100k"]
        wanted = {
            # select_batch(state, deltas, score, layout, m, extra_last_col)
            "select_batch": lambda *a, **kw:
                sum(r for r, _c in a[3]) == CAP_ROWS and a[4] == CAP_M,
            # apply_deltas_to_agg(agg, sub, sel, pot_delta, lbi_delta)
            "apply_deltas": lambda *a, **kw: a[2].shape[0] == CAP_M,
            # select_sources(state, source_score, weight, num_sources)
            "select_sources": lambda *a, **kw: a[3] == CAP_M,
            # score_grid(..., spec, ...) on the wide grid; recheck(...,
            # sub, has_earlier, ...) at m = 2,048
            "score_grid": lambda *a, **kw: a[8].cand_p.shape[0] == CAP_M,
            "score_grid_recheck": lambda *a, **kw:
                a[7].valid.shape[0] == CAP_M,
            # leadership_sources(state, source_score, weight, num_sources)
            "select_sources_leadership": lambda *a, **kw: a[3] == CAP_M,
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
        if not rec_d.calls["segment_reduce_offline"]:
            fail("the drain-50 solve never reached K1's offline mode")
        (drain_offline_state,), _ = rec_d.calls["segment_reduce_offline"][0]
        drain_k2_args, _ = rec_d.calls["select_sources"][0]
        drain_lead_args, _ = rec_d.calls["select_sources_leadership"][0]
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
                                  ("k6", K6_KERNELS["score_grid"]
                                   + K6_KERNELS["score_grid_recheck"])):
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
            "select_batch": check_k3(search_mod, PRE_FIELDS,
                                     rec.picked["select_batch"],
                                     f"{shapes_1k} cap"),
            "apply_deltas": check_k4(agg_mod, rec.picked["apply_deltas"],
                                     f"{shapes_1k} cap")}
        lines["score_grid"], lines["score_grid_recheck"] = check_k6(
            sg_mod, k6_mismatches,
            {"grid": rec.picked["score_grid"][0],
             "recheck": rec.picked["score_grid_recheck"][0]},
            f"{shapes_1k} wide cap", timed=True)
        lines["slot_weights"] = check_k7(
            slot_mod, rec.calls["slot_weights"][0][0], shapes_1k, timed=True)
        lines["select_sources_leadership"] = check_k2_leadership(
            cand_mod, rec.picked["select_sources_leadership"][0],
            f"{shapes_1k} cap")
        lines["select_sources_leadership_drain"] = check_k2_leadership(
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
        lines_7k["select_sources_leadership"] = check_k2_leadership(
            cand_mod, (big, score, weight, CAP_M),
            f"{shapes_7k}, 50 brokers DEAD, round inputs (offline leaders "
            "at 1e30)")
        for case, w, src_b, dst_b in k8_crafted_cases(big, seed=9):
            check_k8(search_mod, (big, w, src_b, dst_b, 4),
                     f"{shapes_7k}, {case}", timed=False)
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
            "score_grid": lambda *a, **kw: a[8].cand_p.shape[0] == CAP_M,
            "score_grid_recheck": lambda *a, **kw:
                a[7].valid.shape[0] == CAP_M})
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
        lines_7k["score_grid"], lines_7k["score_grid_recheck"] = check_k6(
            sg_mod, k6_mismatches,
            {"grid": rec_7k.picked.pop("score_grid")[0],
             "recheck": rec_7k.picked.pop("score_grid_recheck")[0]},
            f"{shapes_7k} cap, targeted column off", timed=True)
        check_k6_goals(sg_mod, k6_mismatches, rec_7k, shapes_7k, k6_held)
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
            search_mod, PRE_FIELDS, k3_call,
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
        print(f"K5: exact against its twin on the {len(SENTINEL_CASES)} "
              f"sentinel cases and 40 small random cases")
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
            check_k7_goals(slot_mod, rec_x, label, k7_held, k7_families)
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
        for goal, where in sorted(k6_held.items()):
            print(f"K6 bitwise equal to its twin, {goal} active: "
                  f"{', '.join(where)}")
        # K7 on every goal no solve above gave a round, with and without
        # the offline override.
        from cruise_control_tpu_torch.analyzer.constraint import (
            BalancingConstraint,
        )
        from cruise_control_tpu_torch.analyzer.derived import compute_derived
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
        "score_grid_recheck": ("cruise_control_tpu_torch/csrc/score_grid.cu",
                               "cruise_control_tpu/analyzer/chain.py:301"),
        "slot_weights": ("cruise_control_tpu_torch/csrc/slot_pass.cu",
                         "cruise_control_tpu/analyzer/chain.py:146"),
        "select_sources_leadership": (
            "cruise_control_tpu_torch/csrc/select_sources.cu",
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
            [lines.pop("select_sources_leadership_drain"), lines_7k[name]]
            if name == "select_sources_leadership" else
            [lines_7k[name]] if name in lines_7k else [])
        if name == "slot_weights":
            line["families"] = [k7_families[f.name]
                                 for f in slot_mod.FAMILY_ARRAYS]
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
                      "total_s": time.time() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
