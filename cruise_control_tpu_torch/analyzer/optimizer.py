"""GoalOptimizer: run the goal chain by priority, collect stats, diff
proposals.

Port of the single-device branches of
``cruise_control_tpu/analyzer/optimizer.py`` (GoalOptimizer.java:435-524):
the fused whole-chain driver up to ``solver.fused.chain.max.brokers``, and
above it (or with ``solver.chain.fused=false``, or in fast mode) the
bounded per-goal driver with its wide and deficit-sized grids, adaptive
dispatch budgets and fingerprint skip. Still unported, and raising
NotImplementedError naming their ROADMAP item: warm starts
(``initial_state``), the solver mesh, the direct-assignment transport
(``solver.direct.assignment.enabled``) and the goals outside the default
chain. The reference's host telemetry (tracer spans, flight recorder,
sensors, shape registry) is not ported either.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..config.cruise_control_config import CruiseControlConfig
from ..model.stats import ClusterModelStats, cluster_stats
from ..model.tensors import ClusterMeta, ClusterTensors
from ..utils.device import resolve_device
from ..warmstart import violation_fingerprint
from .chain import (
    LOOP_STATS, AdaptiveDispatch, DispatchStats, MegastepConfig, _not_ported,
    chain_all_goal_stats, excluded_hosting_replicas, optimize_chain,
    optimize_goal_in_chain,
)
from .constraint import BalancingConstraint, OptimizationOptions
from .goals import ALL_GOALS, NOT_PORTED
from .goals.base import Goal
from .proposals import ExecutionProposal, diff_proposals
from .search import ExclusionMasks, SearchConfig

MAX_BALANCEDNESS_SCORE = 100.0


@dataclasses.dataclass
class GoalResult:
    name: str
    is_hard: bool
    succeeded: bool
    rounds: int
    moves_applied: int
    residual_violation: float
    duration_s: float
    violated_before: bool
    swaps_applied: int = 0


@dataclasses.dataclass
class OptimizerResult:
    proposals: list[ExecutionProposal]
    goal_results: list[GoalResult]
    stats_before: ClusterModelStats
    stats_after: ClusterModelStats
    violated_goals_before: list[str]
    violated_goals_after: list[str]
    balancedness_before: float
    balancedness_after: float
    duration_s: float

    def summary(self) -> dict:
        return {
            "num_proposals": len(self.proposals),
            "num_leadership_only": sum(p.is_leadership_only
                                       for p in self.proposals),
            "violated_goals_before": self.violated_goals_before,
            "violated_goals_after": self.violated_goals_after,
            "balancedness_before": round(self.balancedness_before, 3),
            "balancedness_after": round(self.balancedness_after, 3),
            "duration_s": round(self.duration_s, 3),
            "goals": {g.name: {"rounds": g.rounds, "moves": g.moves_applied,
                               "violation": round(g.residual_violation, 4)}
                      for g in self.goal_results},
        }


def goals_by_priority(cfg: CruiseControlConfig,
                      goal_names: Sequence[str] | None = None) -> list[Goal]:
    """Instantiate the goal chain from dotted class paths (resolved by
    their short name through the registry)."""
    specs = list(goal_names) if goal_names else cfg.get_list("goals")
    goals = []
    for spec in specs:
        short = spec.rsplit(".", 1)[-1]
        cls = ALL_GOALS.get(short)
        if cls is None:
            if short in NOT_PORTED:
                raise _not_ported(short, "Queue A item 10, the remaining "
                                  "goals")
            raise ValueError(f"unknown goal {spec!r}")
        goals.append(cls())
    return goals


def balancedness_score(goals: Sequence[Goal], violated: set[str],
                       priority_weight: float = 1.1,
                       strictness_weight: float = 1.5) -> float:
    """100 minus the normalized weighted cost of violated goals
    (GoalViolationDetector.refreshBalancednessScore:282-287)."""
    weights = []
    for i, g in enumerate(goals):
        w = priority_weight ** (len(goals) - 1 - i)
        if g.is_hard:
            w *= strictness_weight
        weights.append(w)
    total = sum(weights) or 1.0
    cost = sum(w for g, w in zip(goals, weights) if g.name in violated)
    return MAX_BALANCEDNESS_SCORE * (1.0 - cost / total)


def _apportioned_goal_results(goal_chain: Sequence[Goal], infos: list[dict],
                              chain_s: float) -> list[GoalResult]:
    """GoalResults from whole-chain stats; the chain time is apportioned
    by each goal's share of search rounds."""
    total_rounds = sum(info["rounds"] for info in infos) or None
    return [GoalResult(
        name=g.name, is_hard=g.is_hard, succeeded=info["succeeded"],
        rounds=info["rounds"], moves_applied=info["moves_applied"],
        residual_violation=info["residual_violation"],
        duration_s=chain_s * (info["rounds"] / total_rounds
                              if total_rounds else 1 / len(infos)),
        violated_before=info["violated_on_entry"] or not info["succeeded"],
        swaps_applied=info.get("swaps_applied", 0))
        for g, info in zip(goal_chain, infos)]


class GoalOptimizer:
    """Facade over the chain search on one device (the card unless
    ``device="cpu"``)."""

    def __init__(self, config: CruiseControlConfig | None = None,
                 device: "str | torch.device | None" = "cuda", mesh=None):
        if mesh is not None:
            raise _not_ported("A solver mesh", "Queue A item 15, multi-GPU")
        self.device = resolve_device(device)
        self._config = config or CruiseControlConfig()
        self._constraint = BalancingConstraint.from_config(self._config)
        self._cand_budget = self._config.get_int("solver.candidates.per.round")
        self._cand_budget_explicit = \
            "solver.candidates.per.round" in self._config.originals()
        self._moves_base = self._config.get_int("solver.moves.per.round")
        self._max_rounds = self._config.get_int("max.solver.rounds")
        self._priority_weight = self._config.get_double(
            "goal.balancedness.priority.weight")
        self._strictness_weight = self._config.get_double(
            "goal.balancedness.strictness.weight")
        self._fused_chain = self._config.get_boolean("solver.chain.fused")
        self._fused_max_brokers = self._config.get_int(
            "solver.fused.chain.max.brokers")
        self._dispatch_rounds = self._config.get_int(
            "solver.dispatch.max.rounds")
        self._dispatch_target_s = self._config.get_double(
            "solver.dispatch.target.seconds")
        self._async_readback = self._config.get_boolean(
            "solver.dispatch.async.readback")
        self._deficit_moves_cap = self._config.get_int(
            "solver.deficit.moves.cap")
        self._direct_enabled = self._config.get_boolean(
            "solver.direct.assignment.enabled")
        self._fingerprint_skip = self._config.get_boolean(
            "solver.fingerprint.skip.enabled")
        # Adaptive dispatch controllers persist across passes, keyed by the
        # model's shape: the round budget learned on one pass carries to
        # the next pass of the same shape.
        self._controllers: dict = {}
        self._dispatch_stats: DispatchStats | None = None
        self._loop_stats: dict = {}

    def last_dispatch_stats(self) -> dict:
        """Dispatch accounting of the last pass: dispatch_count,
        rounds_per_dispatch_p50, donated and speculative tallies, and on
        the bounded path goals_skipped and violation_fingerprint. Empty
        before any pass."""
        return self._dispatch_stats.as_dict() if self._dispatch_stats \
            else {}

    def last_loop_stats(self) -> dict:
        """Round-loop accounting of the last solve (``chain.LOOP_STATS``):
        graphs captured and their seconds, replays, host reads (one per
        dispatch, the freeze-flag polls, the goal statistics), rounds run
        on the device and how many of them ran frozen. The block graphs
        of the last shape solved are kept across solves and optimizers
        (``chain.clear_graphs`` drops them), so a steady solve captures
        nothing. Empty before any solve."""
        return dict(self._loop_stats)

    def _controller_pair(self, state: ClusterTensors):
        """(narrow, wide) persistent AdaptiveDispatch pair for this model
        shape, created on first use. The reference's key also holds a
        megabatch width and a mesh size, which are 0 and 1 on this
        single-device path."""
        key = (state.num_partitions, state.num_brokers)
        pair = self._controllers.get(key)
        if pair is None:
            pair = (AdaptiveDispatch(max(1, self._dispatch_rounds),
                                     self._dispatch_target_s),
                    AdaptiveDispatch(max(1, self._dispatch_rounds),
                                     self._dispatch_target_s))
            self._controllers[key] = pair
        return pair

    def _megastep_config(self, num_brokers: int) -> MegastepConfig:
        """The bounded path's knobs for one pass. Deficit sizing (and the
        direct transport, which raises) share the wide-batch regime gate
        solver.wide.batch.min.brokers."""
        threshold = self._config.get_int("solver.wide.batch.min.brokers")
        in_regime = threshold > 0 and num_brokers >= threshold
        # solver.megastep.donate is not read: PyTorch has no buffer
        # donation, so the key is accepted and changes nothing.
        return MegastepConfig(
            donate=False,
            async_readback=self._async_readback,
            deficit_moves_cap=self._deficit_moves_cap if in_regime else 0,
            direct_assignment=self._direct_enabled and in_regime)

    @property
    def constraint(self) -> BalancingConstraint:
        return self._constraint

    def search_config(self, state: ClusterTensors) -> SearchConfig:
        """Scale-aware candidate grid (the reference's measured-best
        widths: destinations grow with the broker count, sources fill the
        candidate budget)."""
        b = state.num_brokers
        budget = self._cand_budget if self._cand_budget_explicit \
            else max(self._cand_budget, min(131_072, b * 64))
        num_dests = max(16, min(512, b // 4))
        if self._cand_budget_explicit:
            num_dests = min(num_dests, max(4, budget // 16))
            num_sources = max(16, min(1024, budget // num_dests))
        else:
            num_sources = max(64, min(1024, budget // num_dests))
        moves = max(self._moves_base, min(1024, b // 2))
        return SearchConfig(num_sources=num_sources, num_dests=num_dests,
                            moves_per_round=moves,
                            max_rounds=self._max_rounds)

    def _widen(self, search_cfg: SearchConfig,
               num_brokers: int) -> SearchConfig:
        """The wide grid: sources times solver.wide.batch.source.multiplier
        and twice the moves, each capped at CC_WIDE_CAP (2048) and sources
        also at the broker count, never narrower than ``search_cfg``."""
        mult = self._config.get_int("solver.wide.batch.source.multiplier")
        cap = int(os.environ.get("CC_WIDE_CAP", "2048"))
        return dataclasses.replace(
            search_cfg,
            num_sources=max(search_cfg.num_sources,
                            min(cap, search_cfg.num_sources * mult,
                                num_brokers)),
            moves_per_round=max(search_cfg.moves_per_round,
                                min(cap, search_cfg.moves_per_round * 2)))

    def _wide_config(self, search_cfg: SearchConfig,
                     goal_chain: Sequence[Goal],
                     num_brokers: int) -> SearchConfig | None:
        """The wide grid for the prefers_wide_batches goals of the bounded
        path, or None below solver.wide.batch.min.brokers."""
        threshold = self._config.get_int("solver.wide.batch.min.brokers")
        if threshold <= 0 or num_brokers < threshold \
                or not any(g.prefers_wide_batches for g in goal_chain):
            return None
        return self._widen(search_cfg, num_brokers)

    def _masks(self, state: ClusterTensors, meta: ClusterMeta,
               options: OptimizationOptions) -> ExclusionMasks:
        dev = state.device
        topic_mask = None
        if options.excluded_topics:
            excluded = set(options.excluded_topics)
            topic_mask = torch.as_tensor(np.array(
                [t in excluded for t in meta.topic_names]
                + [False] * (state.num_partitions - len(meta.topic_names)),
                dtype=bool), device=dev)
        idx = {bid: i for i, bid in enumerate(meta.broker_ids)}

        def broker_mask(ids):
            if not ids:
                return None
            m = np.zeros(state.num_brokers, dtype=bool)
            for bid in ids:
                if bid in idx:
                    m[idx[bid]] = True
            return torch.as_tensor(m, device=dev)

        return ExclusionMasks(
            excluded_topics=topic_mask,
            excluded_replica_move_brokers=broker_mask(
                options.excluded_brokers_for_replica_move),
            excluded_leadership_brokers=broker_mask(
                options.excluded_brokers_for_leadership))

    def _check_supported(self, state: ClusterTensors,
                         goal_chain: Sequence[Goal],
                         options: OptimizationOptions,
                         initial_state) -> None:
        if state.device != self.device:
            raise ValueError(f"state is on {state.device}, the optimizer on "
                             f"{self.device}")
        if initial_state is not None:
            raise _not_ported("Warm starts (initial_state)",
                              "Queue A item 13, forecast, futures, warm "
                              "start")
        for g in goal_chain:
            if type(g).__name__ not in ALL_GOALS:
                raise _not_ported(type(g).__name__, "Queue A item 10, the "
                                  "remaining goals")

    def _bounded_chain(self, state: ClusterTensors, meta: ClusterMeta,
                       goal_chain: list[Goal], masks: ExclusionMasks,
                       search_cfg: SearchConfig, megastep: MegastepConfig,
                       stats: DispatchStats, fast: bool,
                       fast_budget_s: float,
                       ) -> tuple[ClusterTensors, list[GoalResult]]:
        """The per-goal branch: each goal's passes run as dispatches of at
        most solver.dispatch.max.rounds rounds (adaptive), or as one
        dispatch each with solver.chain.fused=false outside fast mode."""
        dispatch_rounds = self._dispatch_rounds \
            if (self._fused_chain or fast) else 0
        ctl_pair = self._controller_pair(state) if dispatch_rounds > 0 \
            else (None, None)
        # Fast mode's grid is wide for every goal, so its dispatches belong
        # to the wide controller's cost class; so do the wide goals and the
        # deficit-sized count goals.
        controller = ctl_pair[1] if fast else ctl_pair[0]
        wide_cfg = None if fast else self._wide_config(
            search_cfg, goal_chain, state.num_brokers)
        deficit_sizing = megastep.deficit_moves_cap > 0
        # Fingerprint skip: one snapshot of every goal's entry stats; while
        # no goal has changed the state, each goal's entry stats come from
        # it and a goal it shows idle takes no dispatch.
        hint_viol = hint_obj = None
        hint_off = 0
        hint_drain = None
        if self._fingerprint_skip and not fast:
            hint_viol, hint_obj, hint_off = chain_all_goal_stats(
                state, tuple(goal_chain), self._constraint, meta.num_topics,
                masks)
            hint_drain = False
            if masks.excluded_replica_move_brokers is not None:
                hint_drain = bool(excluded_hosting_replicas(
                    state, masks.excluded_replica_move_brokers).any())
            stats.fingerprint = violation_fingerprint(hint_viol)
        goal_results = []
        chain_owns_state = False
        for i, g in enumerate(goal_chain):
            t0 = time.time()
            use_wide = wide_cfg is not None and g.prefers_wide_batches
            wide_class = use_wide or (deficit_sizing and g.count_based)
            entry = None
            if hint_viol is not None and not chain_owns_state:
                entry = (float(hint_viol[i]), float(hint_obj[i]), hint_off)
            state, info = optimize_goal_in_chain(
                state, goal_chain, i, self._constraint,
                wide_cfg if use_wide else search_cfg, meta.num_topics, masks,
                dispatch_rounds=dispatch_rounds,
                dispatch=ctl_pair[1] if wide_class else controller,
                wall_budget_s=fast_budget_s, megastep=megastep, stats=stats,
                entry_stats=entry,
                drain_hint=hint_drain if entry is not None else None)
            chain_owns_state |= info["rounds"] > 0
            goal_results.append(GoalResult(
                name=g.name, is_hard=g.is_hard, succeeded=info["succeeded"],
                rounds=info["rounds"], moves_applied=info["moves_applied"],
                residual_violation=info["residual_violation"],
                duration_s=time.time() - t0,
                violated_before=info["violated_on_entry"]
                or not info["succeeded"],
                swaps_applied=info.get("swaps_applied", 0)))
        return state, goal_results

    def optimizations(self, state: ClusterTensors, meta: ClusterMeta,
                      goals: Sequence[Goal] | None = None,
                      options: OptimizationOptions | None = None,
                      initial_state: ClusterTensors | None = None,
                      ) -> tuple[ClusterTensors, OptimizerResult]:
        """Run the goal chain; returns (final_state, OptimizerResult)."""
        t_start = time.time()
        options = options or OptimizationOptions()
        goal_chain = list(goals) if goals is not None \
            else goals_by_priority(self._config)
        self._check_supported(state, goal_chain, options, initial_state)
        masks = self._masks(state, meta, options)
        search_cfg = self.search_config(state)
        # Fast mode: every goal runs the wide grid, and each goal's search
        # wall-clock is capped at the per-broker timeout times the brokers.
        fast = bool(options.fast_mode)
        if fast:
            search_cfg = self._widen(search_cfg, state.num_brokers)
        fast_budget_s = (self._config.get_long(
            "fast.mode.per.broker.move.timeout.ms") * state.num_brokers
            / 1000.0) if fast else 0.0
        stats_before = cluster_stats(state)
        stats = DispatchStats()
        self._dispatch_stats = stats
        LOOP_STATS.clear()
        megastep = self._megastep_config(state.num_brokers)

        if self._fused_chain and not fast and (
                self._fused_max_brokers == 0
                or state.num_brokers <= self._fused_max_brokers):
            # The whole chain in one driver call.
            t0 = time.time()
            final, infos = optimize_chain(state, goal_chain,
                                          self._constraint, search_cfg,
                                          meta.num_topics, masks)
            stats.record("chain", sum(i["rounds"] for i in infos))
            goal_results = _apportioned_goal_results(goal_chain, infos,
                                                     time.time() - t0)
        else:
            final, goal_results = self._bounded_chain(
                state, meta, goal_chain, masks, search_cfg, megastep,
                stats, fast, fast_budget_s)
        self._loop_stats = dict(LOOP_STATS)
        violated_before = [r.name for r in goal_results if r.violated_before]
        violated_after = [r.name for r in goal_results if not r.succeeded]
        stats_after = cluster_stats(final)
        proposals = diff_proposals(state, final, meta)
        result = OptimizerResult(
            proposals=proposals, goal_results=goal_results,
            stats_before=stats_before, stats_after=stats_after,
            violated_goals_before=violated_before,
            violated_goals_after=violated_after,
            balancedness_before=balancedness_score(
                goal_chain, set(violated_before), self._priority_weight,
                self._strictness_weight),
            balancedness_after=balancedness_score(
                goal_chain, set(violated_after), self._priority_weight,
                self._strictness_weight),
            duration_s=time.time() - t_start,
        )
        return final, result
