"""Logical-plan optimizer for ray_tpu_torch.data — a rule framework.

Analog of the reference's logical optimizer (``python/ray/data/_internal/
logical/optimizers.py`` + ``logical/rules/``): a LogicalOptimizer holds an
ordered RULE LIST; each rule is a named plan→plan rewrite; the optimizer
applies the list in passes until a fixpoint. Our plan is the
``(sources, ops)`` pair a ``Dataset`` carries — sources may include
``_LazyExchange`` nodes (deferred all-to-all stages), ops are the fused
per-block transform chain — so rules are list rewrites plus hoists across
the exchange boundary.

Built-in rules, in application order:

  * ``MergeProjections`` — select∘select → the final select;
    drop∘drop → one combined drop (fewer per-block arrow calls);
  * ``MergeLimits`` — limit(a)∘limit(b) → limit(min(a, b));
  * ``FuseRowOps`` — map(f)∘map(g) → map(g∘f) and
    filter(p)∘filter(q) → filter(p and q): one per-row Python dispatch
    instead of two (reference: operator fusion,
    ``logical/rules/operator_fusion.py``);
  * ``PushLimitEarly`` — move a ``limit`` before row-count-preserving
    ops (map / add_column / select / drop / rename) so those ops run on
    at most ``n`` rows per block (reference: LimitPushdownRule);
  * ``HoistAcrossExchange`` — move leading filters (always safe: row
    predicates commute with partitioning) and projections (safe when the
    exchange's key survives the projection) from AFTER an exchange into
    its parent pipeline, shrinking the bytes that cross the shuffle.

``optimize(sources, ops)`` returns ``(sources, ops, trace)`` where trace
is a human-readable list of the rewrites applied — ``Dataset.explain()``
surfaces it and the unit tests assert on it. Custom rules can be
appended to ``DEFAULT_RULES`` (each entry: a ``Rule`` subclass instance).
"""

from __future__ import annotations

from typing import Any, List, Tuple

# Ops that preserve row count AND row order 1:1 (limit may move before
# them). filter / flat_map / map_batches can change the count; exchange
# boundaries reorder.
_ROW_PRESERVING = {"map", "add_column", "select_columns", "drop_columns",
                   "rename_columns", "enforce_schema"}


class Rule:
    """One named plan rewrite. ``apply`` returns the (possibly new)
    ``(sources, ops)``; any rewrite performed must append a line to
    ``trace`` — the optimizer uses trace growth as its fixpoint signal."""

    name = "rule"

    def apply(self, sources: List[Any], ops: List[Any],
              trace: List[str]) -> Tuple[List[Any], List[Any]]:
        raise NotImplementedError


def _is_projection(op) -> bool:
    return op.kind in ("select_columns", "drop_columns")


class MergeProjections(Rule):
    name = "merge_projections"

    def apply(self, sources, ops, trace):
        out: List[Any] = []
        for op in ops:
            if out and _is_projection(op) and _is_projection(out[-1]):
                prev = out[-1]
                if (prev.kind == "select_columns"
                        and op.kind == "select_columns"):
                    # Merge only when provably valid (B ⊆ A): otherwise
                    # the unoptimized chain raises on the missing column
                    # and the merged form would silently mask that bug.
                    if set(op.kw["cols"]) <= set(prev.kw["cols"]):
                        out[-1] = op
                        trace.append(
                            "merge_projections: select∘select -> select")
                        continue
                if (prev.kind == "drop_columns"
                        and op.kind == "drop_columns"):
                    # Overlapping drops raise unmerged (second drop names
                    # an already-dropped column) — keep that error.
                    if not (set(prev.kw["cols"]) & set(op.kw["cols"])):
                        merged = (list(prev.kw["cols"])
                                  + list(op.kw["cols"]))
                        out[-1] = type(op)("drop_columns", cols=merged)
                        trace.append(
                            "merge_projections: drop∘drop -> drop")
                        continue
                if (prev.kind == "select_columns"
                        and op.kind == "drop_columns"):
                    if set(op.kw["cols"]) <= set(prev.kw["cols"]):
                        kept = [c for c in prev.kw["cols"]
                                if c not in set(op.kw["cols"])]
                        out[-1] = type(op)("select_columns", cols=kept)
                        trace.append(
                            "merge_projections: select∘drop -> select")
                        continue
            out.append(op)
        return sources, out


class MergeLimits(Rule):
    name = "merge_limits"

    def apply(self, sources, ops, trace):
        out: List[Any] = []
        for op in ops:
            if (out and op.kind == "limit"
                    and out[-1].kind == "limit"):
                n = min(int(out[-1].kw["n"]), int(op.kw["n"]))
                out[-1] = type(op)("limit", n=n)
                trace.append(f"merge_limits: limit∘limit -> limit({n})")
                continue
            out.append(op)
        return sources, out


def _compose_maps(f, g):
    return lambda row: g(f(row))


def _and_filters(p, q):
    return lambda row: p(row) and q(row)


class FuseRowOps(Rule):
    """map(f)∘map(g) -> map(g∘f); filter(p)∘filter(q) -> filter(p∧q).

    Both are row-local and effect-order-preserving, so fusion only
    removes per-row dispatch overhead. Class-UDF map_batches is NOT
    fused — those ops carry their own actor-pool placement."""

    name = "fuse_row_ops"

    def apply(self, sources, ops, trace):
        out: List[Any] = []
        for op in ops:
            if out and op.kind == "map" and out[-1].kind == "map":
                out[-1] = type(op)("map",
                                   _compose_maps(out[-1].fn, op.fn))
                trace.append("fuse_row_ops: map∘map -> map")
                continue
            if out and op.kind == "filter" and out[-1].kind == "filter":
                out[-1] = type(op)("filter",
                                   _and_filters(out[-1].fn, op.fn))
                trace.append("fuse_row_ops: filter∘filter -> filter")
                continue
            out.append(op)
        return sources, out


class PushLimitEarly(Rule):
    name = "push_limit_early"

    def apply(self, sources, ops, trace):
        ops = list(ops)
        moved = True
        while moved:
            moved = False
            for i in range(1, len(ops)):
                if (ops[i].kind == "limit"
                        and ops[i - 1].kind in _ROW_PRESERVING):
                    ops[i - 1], ops[i] = ops[i], ops[i - 1]
                    trace.append(
                        f"push_limit_early: limit before {ops[i].kind}")
                    moved = True
        return sources, ops


def _exchange_key(node) -> Any:
    return getattr(node, "key", None)


def _projection_keeps(op, key) -> bool:
    if key is None:
        return True
    if op.kind == "select_columns":
        return key in set(op.kw["cols"])
    if op.kind == "drop_columns":
        return key not in set(op.kw["cols"])
    return False


class HoistAcrossExchange(Rule):
    """Move leading filter/projection ops into a sole upstream exchange's
    parent pipeline. Applies only when the dataset's sources are exactly
    one deferred exchange (the shape ``repartition/shuffle/sort`` (lazy)
    produce); the exchange itself re-optimizes its parents at expansion,
    so hoists chain through stacked exchanges."""

    name = "hoist_across_exchange"

    def apply(self, sources, ops, trace):
        from .dataset import _LazyExchange

        if len(sources) != 1 or not isinstance(sources[0], _LazyExchange):
            return sources, ops
        node = sources[0]
        hoisted = 0
        while ops:
            op = ops[0]
            if op.kind == "filter":
                ok = True
            elif _is_projection(op):
                ok = _projection_keeps(op, _exchange_key(node))
            else:
                ok = False
            if not ok:
                break
            node = node.with_extra_parent_op(op)
            ops = ops[1:]
            hoisted += 1
            trace.append(
                f"hoist_across_exchange: {op.kind} moved before "
                f"{node.how} exchange")
        if hoisted:
            sources = [node]
        return sources, ops


DEFAULT_RULES: List[Rule] = [
    MergeProjections(),
    MergeLimits(),
    FuseRowOps(),
    PushLimitEarly(),
    HoistAcrossExchange(),
]

_MAX_PASSES = 5


def optimize(sources: List[Any], ops: List[Any],
             rules: List[Rule] = None
             ) -> Tuple[List[Any], List[Any], List[str]]:
    """Apply the rule list in passes until a fixpoint (no rule rewrote
    anything in a full pass) or the pass cap — one rule's rewrite can
    enable another's (e.g. PushLimitEarly making two limits adjacent for
    MergeLimits)."""
    trace: List[str] = []
    active = DEFAULT_RULES if rules is None else rules
    for _ in range(_MAX_PASSES):
        before = len(trace)
        for rule in active:
            sources, ops = rule.apply(sources, ops, trace)
        if len(trace) == before:
            break
    return sources, ops, trace
