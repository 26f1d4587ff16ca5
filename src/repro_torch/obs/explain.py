"""EXPLAIN: render a PreparedQuery's plan as deterministic text.

Answers "what did the planner decide and what did it cost" for one
template: the IDMap candidate intervals, the §4.3 check decision with
the τ comparisons that drove it, the D-tree decomposition, the Selinger
join order with estimated-vs-observed cardinalities and the chosen join
strategies, and the connection-edge order with its reach/cross pricing.

Template-level fields are available right after `Engine.prepare`; the
learned sections (join orders, strategies, observed join sizes) render
as ``(unlearned — cold execution pending)`` until the first execution
fills them in.  Everything is duck-typed over the PreparedQuery /
PlanDecision / Thresholds field names — this module imports nothing
from ``repro_torch.core`` at module scope, so ``obs`` stays import-cycle-free
below the core.
"""
from __future__ import annotations


def _fmt(v: float) -> str:
    """Deterministic compact float: ints as ints, else 4 significant
    digits (no locale, no exponent jitter across platforms)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return f"{f:.4g}"


def _fp_short(fingerprint) -> str:
    if not fingerprint:
        return "(unfingerprinted)"
    s = str(fingerprint)
    return s if len(s) <= 40 else s[:40] + "..."


def _check_lines(pq, thresholds) -> list[str]:
    d = pq.decision
    state = "ON" if pq.use_check else "OFF"
    if d is None:
        return [f"check decision (§4.3): {state} "
                "(forced by check_policy, no τ evaluation)"]
    lines = [f"check decision (§4.3): {state}"]
    if thresholds is not None:
        from ..core.planner import decision_terms
        for t in decision_terms(d, thresholds):
            lines.append(
                f"  {t['name']}: {_fmt(t['value'])} {t['op']} "
                f"{t['tau']}={_fmt(t['threshold'])} -> "
                f"{'hit' if t['hit'] else 'miss'}")
        lines.append(f"  => use_check = complex AND power "
                     f"= {pq.use_check}")
    else:
        lines.append(
            f"  complex={d.complex_query} "
            f"est_iterations={_fmt(d.est_iterations)} "
            f"est_join_product={_fmt(d.est_join_product)} "
            f"max_selectivity={_fmt(d.max_selectivity)}")
    sel = getattr(d, "per_node_selectivity", None) or {}
    if sel:
        body = " ".join(f"q{q}={_fmt(sel[q])}" for q in sorted(sel))
        lines.append(f"  per-node N_q selectivity: {body}")
    return lines


def _candidate_lines(pq) -> list[str]:
    lines = ["candidates (IDMap intervals):"]
    iv = pq.iv
    for q in sorted(pq.cand_sizes):
        lo, hi = int(iv[q, 0]), int(iv[q, 1])
        lines.append(f"  q{q} [{lo}, {hi}) -> {pq.cand_sizes[q]}")
    total = sum(pq.cand_sizes.values())
    after = None
    masks = getattr(pq, "masks", None)
    if masks is not None:
        after = masks[2]
    lines.append(f"  total before check: {total}"
                 + (f", after: {after}" if after is not None else ""))
    return lines


def _component_lines(pq) -> list[str]:
    lines = [f"components: {len(pq.comps)}"]
    for ci, (comp, trees) in enumerate(zip(pq.comps, pq.trees_per_comp)):
        lines.append(f"  component {ci}: nodes {list(comp)}")
        for tr in trees:
            edges = ", ".join(
                (f"q{tr.root}-[{'*' if p is None else p}]->q{c}" if out
                 else f"q{c}-[{'*' if p is None else p}]->q{tr.root}")
                for p, c, out in tr.edges)
            lines.append(f"    d-tree root=q{tr.root}: "
                         + (edges if edges else "(single node)"))
    return lines


def _join_order_lines(pq) -> list[str]:
    lines = ["join order (Selinger DP over per-tree tables):"]
    any_learned = False
    for ci in range(len(pq.comps)):
        if ci in pq.comp_orders:
            any_learned = True
            order = pq.comp_orders[ci]
            cost, greedy = pq.comp_costs.get(ci, (0.0, 0.0))
            lines.append(
                f"  component {ci}: trees in order {list(order)} "
                f"est_cost={_fmt(cost)} (greedy would be {_fmt(greedy)})")
    if not any_learned:
        lines.append("  (unlearned — cold execution pending, or single"
                     " d-tree per component)")
    return lines


def _connection_lines(pq) -> list[str]:
    conns = list(getattr(pq.query, "connections", ()) or ())
    if not conns:
        return ["connection edges: none"]
    lines = [f"connection edges: {len(conns)}"]
    for i, c in enumerate(conns):
        arrow = "<->" if c.bidirectional else "->"
        lines.append(f"  #{i} q{c.src} {arrow} q{c.dst} "
                     f"(max_dist={c.max_dist})")
    if pq.conn_order is not None:
        cost, greedy = pq.conn_costs
        lines.append(f"  merge order {list(pq.conn_order)} "
                     f"est_cost={_fmt(cost)} "
                     f"(greedy would be {_fmt(greedy)})")
    if pq.conn_impls:
        lines.append("  edge strategies (reach/cross, processing order): "
                     + " ".join(pq.conn_impls))
    if pq.conn_order is None and not pq.conn_impls:
        lines.append("  (unlearned — cold execution pending)")
    return lines


def _join_seq_lines(pq) -> list[str]:
    seq = pq.join_seq
    if not seq:
        return ["learned join sequence: (unlearned — cold execution"
                " pending)"]
    ests = list(getattr(pq, "join_est_seq", ()) or ())
    lines = [f"learned join sequence ({len(seq)} estimator-sized joins,"
             " engine call order):"]
    for i, (rows, cap, impl) in enumerate(seq):
        est = ests[i] if i < len(ests) else None
        est_s = "-" if est is None else _fmt(est)
        lines.append(f"  #{i} impl={impl} est={est_s} rows={rows} "
                     f"cap={cap}")
    return lines


def render_explain(pq, thresholds=None) -> str:
    """Multi-line EXPLAIN text for one PreparedQuery.  `thresholds`
    (a planner.Thresholds) enables the τ-comparison rendering of the
    §4.3 decision; without it only the decision inputs are shown."""
    lines = [f"EXPLAIN template {_fp_short(pq.fingerprint)}",
             f"  executions={pq.executions} "
             f"calibration_version={pq.version} "
             f"prepare_time={pq.prepare_time * 1e3:.2f}ms"]
    for block in (_candidate_lines(pq), _check_lines(pq, thresholds),
                  _component_lines(pq), _join_order_lines(pq),
                  _connection_lines(pq), _join_seq_lines(pq)):
        lines.extend(block)
    return "\n".join(lines)
