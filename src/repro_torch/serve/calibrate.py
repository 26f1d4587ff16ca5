"""Self-calibrating pruning and cost-model constants.

The paper's §4.3 decision — run the neighborhood check or not — hinges on
the τ1–τ3 thresholds, and the planner's join/connection cost models hinge
on analytic cardinality estimates.  Both are tuned offline in the paper;
in a serving setting the system observes its own executions, so the
Calibrator closes the loop online:

  * join_est_scale   from the signed join-estimate log bias
                     (QueryStats.join_est_log_bias): a planner that
                     systematically over-estimates join sizes gets its
                     estimates shrunk, and vice versa.
  * conn_sel_scale   from observed vs. predicted connected-pair counts
                     (conn_connected_pairs vs conn_est_pairs): corrects
                     connection_selectivity on datasets whose reach
                     structure the geometric-fanout model misses.
  * reach_scale      from observed vs. predicted reach-pair-table rows
                     (conn_reach_pairs vs conn_est_reach_pairs): corrects
                     the reach-join side of connection_edge_cost, i.e.
                     the per-edge reach-vs-cross strategy choice.
  * τ1–τ3            rule-based bounded steps: a check that ran but
                     barely pruned while costing real time raises τ3
                     (demand more selectivity); a skipped check followed
                     by join work far above τ2 lowers τ1/τ2 (classify
                     such templates as complex next time).

All updates are multiplicative, EWMA-smoothed, and clipped to bounded
ranges around the defaults, and none of them can change query *results*
— thresholds and cost constants only steer pruning/strategy/order
choices, every one of which is exact.  `version` increments whenever a
threshold moves; the PlanCache uses it to invalidate prepared decisions
made under stale thresholds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.engine import QueryStats
from ..core.planner import Thresholds, CostModel


@dataclass
class Ewma:
    """Exponentially weighted running mean (None until first update)."""
    alpha: float = 0.25
    value: float | None = None
    n: int = 0

    def update(self, x: float) -> float:
        self.value = x if self.value is None \
            else (1 - self.alpha) * self.value + self.alpha * x
        self.n += 1
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


def _clip(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


class Calibrator:
    """Aggregates per-query QueryStats into per-dataset running telemetry
    and feeds calibrated thresholds / cost-model constants back into the
    planner.  Mutates the `Thresholds` and `CostModel` objects it is
    handed IN PLACE — hand it the engine's own cfg objects and every
    later plan sees the calibrated values without further plumbing."""

    TAU_BOUND = 16.0            # each τ stays within default / x bound
    SCALE_BOUND = 8.0           # join/reach scales stay within 1/x .. x
    SEL_BOUND = 64.0            # selectivity correction range

    def __init__(self, thresholds: Thresholds, cost_model: CostModel,
                 alpha: float = 0.25,
                 bounds_ref: Thresholds | None = None):
        self.thresholds = thresholds
        self.cost_model = cost_model
        # τ movement is bounded around a reference grid, NOT around the
        # starting values: a miscalibrated start (the situation
        # calibration exists to repair) must not anchor its own cage.
        # The default reference is the paper's canonical thresholds.
        ref = bounds_ref if bounds_ref is not None else Thresholds()
        self._tau_defaults = (ref.tau_iter, ref.tau_join, ref.tau_sel)
        self.version = 0
        self.observed = 0
        self.degraded_skipped = 0
        self.chronic_notices = 0
        self.chronic_fps: list[str] = []
        self._join_bias = Ewma(alpha)
        self._conn_sel = Ewma(alpha)
        self._reach = Ewma(alpha)

    # ------------------------------------------------------------------ #
    def observe(self, qs: QueryStats) -> None:
        """Fold one executed query's stats into the running calibration.
        Only cold executions carry new evidence — warm ones replay the
        cold run's decisions and sizes verbatim."""
        self.observed += 1
        if qs.cache_hit:
            # cold-run evidence only, uniformly: a warm repeat replays
            # the first run's masks, join sizes, and connection
            # strategies, so every one of its ratios is the same
            # observation folded in again — a hot template would
            # otherwise dominate the EWMAs by repetition count
            return
        if qs.degraded_steps:
            # degraded-ladder executions ran under forced non-default
            # settings (check off, forced impls, reduced caps) — their
            # estimate/observation ratios describe the degraded config,
            # not the primary one the thresholds and cost model govern
            self.degraded_skipped += 1
            return
        cm = self.cost_model
        b = self.SCALE_BOUND
        if qs.n_estimated_joins:
            # the recorded bias was measured on estimates that already
            # had join_est_scale applied — divide it back out so the
            # EWMA tracks the RAW model's bias.  (Setting the scale
            # absolutely from the post-scale bias converges to only half
            # the correction in log space: a 16x raw over-estimate would
            # settle at scale 1/4 instead of 1/16.)
            raw = (qs.join_est_log_bias / qs.n_estimated_joins
                   - math.log(max(cm.join_est_scale, 1e-12)))
            bias = self._join_bias.update(raw)
            cm.join_est_scale = _clip(math.exp(-bias), 1.0 / b, b)
        if qs.conn_est_pairs > 0:
            r = self._conn_sel.update(
                math.log((qs.conn_connected_pairs + 1.0)
                         / (qs.conn_est_pairs + 1.0)))
            cm.conn_sel_scale = _clip(math.exp(r), 1.0 / self.SEL_BOUND,
                                      self.SEL_BOUND)
        if qs.conn_est_reach_pairs > 0 and qs.conn_reach_pairs > 0:
            r = self._reach.update(
                math.log((qs.conn_reach_pairs + 1.0)
                         / (qs.conn_est_reach_pairs + 1.0)))
            cm.reach_scale = _clip(math.exp(r), 1.0 / b, b)
        self._update_thresholds(qs)

    def _update_thresholds(self, qs: QueryStats) -> None:
        th = self.thresholds
        d_iter, d_join, d_sel = self._tau_defaults
        bound = self.TAU_BOUND
        before = (th.tau_iter, th.tau_join, th.tau_sel)
        if qs.used_check and qs.plan is None:
            # check forced by policy ('always'), not decided by the τ
            # thresholds — no decide() evidence, nothing to learn from
            pass
        elif qs.used_check:
            # pruning power is measured by the candidate ratio alone —
            # wall times are useless for this rule online (cold runs are
            # compile-dominated, warm runs replay cached masks at zero
            # check cost), but the ratio is exact on every cold run.
            # τ3 is maintained as a running *separator* between observed
            # selectivities: a template whose selectivity S failed to
            # prune is direct evidence that τ3 must exceed S, and a
            # template that pruned well is evidence τ3 must not — one
            # observation per template moves τ3 past it, instead of
            # creeping multiplicatively.
            prune = qs.candidates_after / max(qs.candidates_before, 1)
            s = qs.plan.max_selectivity if qs.plan is not None else None
            if prune > 0.9:
                target = s * 1.1 if s is not None else th.tau_sel * 1.5
                th.tau_sel = _clip(max(th.tau_sel, target), d_sel / bound,
                                   d_sel * bound)
            elif prune < 0.5:
                target = s * 0.95 if s is not None else th.tau_sel / 1.1
                th.tau_sel = _clip(min(th.tau_sel, target), d_sel / bound,
                                   d_sel * bound)
        elif qs.plan is not None and not qs.plan.complex_query:
            work = qs.join_work + qs.dtree_work
            if work > 4.0 * th.tau_join:
                # "not complex" misclassification: actual join work blew
                # past τ2 — tighten both complexity gates
                th.tau_iter = _clip(th.tau_iter / 1.25, d_iter / bound,
                                    d_iter * bound)
                th.tau_join = _clip(th.tau_join / 1.25, d_join / bound,
                                    d_join * bound)
        if (th.tau_iter, th.tau_join, th.tau_sel) != before:
            self.version += 1

    # ------------------------------------------------------------------ #
    def note_chronic(self, fingerprint: str) -> None:
        """A template stayed degraded past the governor's chronic
        threshold: its plan keeps failing under the primary config, so
        re-plan rather than re-try.  The version bump forces every
        cached decision through `Engine.revalidate` (cheap — pure
        template arithmetic), and the fingerprint is kept (bounded) for
        telemetry/offline analysis."""
        self.chronic_notices += 1
        if fingerprint not in self.chronic_fps:
            self.chronic_fps.append(fingerprint)
            del self.chronic_fps[:-64]
        self.version += 1

    def note_delta(self) -> None:
        """The dataset absorbed a delta: stats shifted, so the §4.3
        decision baked into every cached plan may have flipped even
        though no threshold moved.  Bumping the version routes each
        cached entry through `Engine.revalidate` on its next use (and
        lets the server re-decide eagerly during plan-cache migration)."""
        self.version += 1

    def save_state(self) -> dict:
        """Serializable learned state (thresholds, scales, EWMAs) for
        warm-restart snapshots; restored by `load_state`."""
        th, cm = self.thresholds, self.cost_model
        return {
            "version": self.version,
            "observed": self.observed,
            "degraded_skipped": self.degraded_skipped,
            "chronic_notices": self.chronic_notices,
            "chronic_fps": list(self.chronic_fps),
            "thresholds": {"tau_iter": th.tau_iter,
                           "tau_join": th.tau_join,
                           "tau_sel": th.tau_sel,
                           "nested_join_max": th.nested_join_max},
            "cost_model": {"join_est_scale": cm.join_est_scale,
                           "conn_sel_scale": cm.conn_sel_scale,
                           "reach_scale": cm.reach_scale,
                           "cross_scale": cm.cross_scale},
            "ewma": {name: {"alpha": e.alpha, "value": e.value, "n": e.n}
                     for name, e in (("join_bias", self._join_bias),
                                     ("conn_sel", self._conn_sel),
                                     ("reach", self._reach))},
        }

    def load_state(self, state: dict) -> None:
        """Restore `save_state` output IN PLACE on the same Thresholds /
        CostModel objects the engine plans with."""
        th, cm = self.thresholds, self.cost_model
        for k, v in state.get("thresholds", {}).items():
            setattr(th, k, v)
        for k, v in state.get("cost_model", {}).items():
            setattr(cm, k, v)
        for name, e in (("join_bias", self._join_bias),
                        ("conn_sel", self._conn_sel),
                        ("reach", self._reach)):
            s = state.get("ewma", {}).get(name)
            if s is not None:
                e.alpha = float(s["alpha"])
                e.value = None if s["value"] is None else float(s["value"])
                e.n = int(s["n"])
        self.version = int(state.get("version", 0))
        self.observed = int(state.get("observed", 0))
        self.degraded_skipped = int(state.get("degraded_skipped", 0))
        self.chronic_notices = int(state.get("chronic_notices", 0))
        self.chronic_fps = [str(f) for f in state.get("chronic_fps", [])]

    def snapshot(self) -> dict:
        th, cm = self.thresholds, self.cost_model
        return {
            "observed": self.observed,
            "degraded_skipped": self.degraded_skipped,
            "chronic_notices": self.chronic_notices,
            "version": self.version,
            "tau_iter": th.tau_iter,
            "tau_join": th.tau_join,
            "tau_sel": th.tau_sel,
            "join_est_scale": cm.join_est_scale,
            "conn_sel_scale": cm.conn_sel_scale,
            "reach_scale": cm.reach_scale,
            "cross_scale": cm.cross_scale,
            "join_bias_ewma": self._join_bias.get(),
            "conn_sel_ewma": self._conn_sel.get(),
            "reach_ewma": self._reach.get(),
        }
