"""Logical plan nodes + the dataframe-ish builder.

A plan is an immutable tree of :class:`Node` records.  Every node knows
its output ``schema`` (a tuple of column names) and a content-addressed
``fingerprint`` — sha256 over the node's own spec plus its children's
fingerprints.  The fingerprint is the *logical* identity: PlanFeedback
keys observed stats and replan decisions on it, and the planner derives
deterministic vertex names from it so identical subplans lower to
identical vertices and hit the sealed-lineage store across queries
(docs/query.md, docs/store.md).

Semantics are deliberately small and exact: rows are tuples of strings,
comparisons are lexicographic unless ``numeric`` asks for int parsing,
aggregates are integer count/sum/min/max.  That keeps every operator
bit-exact against the numpy oracle in tools/query_corpus.py under any
physical strategy.

The port's copy of tez_tpu.query.logical: a plan's fingerprint is
tez_tpu's for the same plan.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: filter comparators (runtime evaluation in query/processors.py)
CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge", "contains")
AGG_FNS = ("count", "sum", "min", "max")
JOIN_HOW = ("inner", "semi", "semi_distinct")
WINDOW_FNS = ("row_number", "cume_sum")


@dataclasses.dataclass(frozen=True)
class Node:
    """One logical operator.  ``spec`` holds the op-specific parameters
    (JSON-serializable), ``children`` the input plans in order."""
    op: str
    spec: Dict[str, Any]
    children: Tuple["Node", ...]
    schema: Tuple[str, ...]

    @property
    def fingerprint(self) -> str:
        body = json.dumps(
            {"op": self.op, "spec": self.spec,
             "children": [c.fingerprint for c in self.children]},
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(body.encode()).hexdigest()[:16]

    def describe(self) -> str:
        """Short operator label for vertex tags and journal events."""
        s = self.spec
        if self.op == "scan":
            return f"scan({s['table']})"
        if self.op == "filter":
            return f"filter({s['col']}{s['cmp']}{s['value']})"
        if self.op == "project":
            return f"project({','.join(s['columns'])})"
        if self.op == "join":
            return f"{s['how']}_join({s['left_key']}={s['right_key']})"
        if self.op == "aggregate":
            return f"aggregate({','.join(s['keys'])})"
        if self.op == "window":
            return f"window({s['func']}/{s['partition']})"
        if self.op == "limit":
            return f"limit({s['n']})"
        return self.op

    def walk(self) -> List["Node"]:
        out: List[Node] = []
        for c in self.children:
            out.extend(c.walk())
        out.append(self)
        return out

    def estimated_bytes(self) -> int:
        """Static size estimate (docs/query.md "strategy selection"):
        scans stat their files; everything narrower passes its input
        through unchanged — the planner deliberately cannot see through
        a selective filter, which is exactly what the observed-stats
        replan path exists to correct."""
        if self.op == "scan":
            total = 0
            for p in self.spec["paths"]:
                try:
                    total += os.path.getsize(p)
                except OSError:
                    pass
            return total
        if self.op == "join":
            return sum(c.estimated_bytes() for c in self.children)
        if self.op == "limit":
            return min(self.children[0].estimated_bytes(), 1 << 16)
        return self.children[0].estimated_bytes()


def _col_index(schema: Sequence[str], col: str) -> int:
    try:
        return list(schema).index(col)
    except ValueError:
        raise KeyError(f"column {col!r} not in schema {tuple(schema)}")


class Table:
    """Dataframe-ish builder over :class:`Node` trees.

    ::

        orders = Table.scan("orders", paths, ["o_orderkey", "o_custkey",
                                              "o_total"])
        q = (orders.filter("o_total", "ge", "00000500", numeric=False)
                   .join(customer, "o_custkey", "c_custkey")
                   .aggregate(["c_nation"], [("revenue", "sum", "o_total")])
                   .limit(10, ["c_nation"]))

    Each method returns a new Table; the underlying plan is ``.plan``.
    """

    def __init__(self, plan: Node):
        self.plan = plan

    @property
    def schema(self) -> Tuple[str, ...]:
        return self.plan.schema

    # -- leaves --------------------------------------------------------

    @staticmethod
    def scan(table: str, paths: Sequence[str], columns: Sequence[str],
             mode: str = "table", delimiter: str = "|") -> "Table":
        """``mode``: 'table' = one row per line, columns split on
        ``delimiter``; 'lines' = one single-column row per non-empty
        stripped line; 'words' = one single-column row per whitespace
        token (the wordcount-ish corpora the examples use)."""
        if mode not in ("table", "lines", "words"):
            raise ValueError(f"bad scan mode {mode!r}")
        if mode in ("lines", "words") and len(columns) != 1:
            raise ValueError(f"scan mode {mode!r} is single-column")
        node = Node("scan", {"table": table, "paths": list(paths),
                             "columns": list(columns), "mode": mode,
                             "delimiter": delimiter},
                    (), tuple(columns))
        return Table(node)

    # -- row ops -------------------------------------------------------

    def filter(self, col: str, cmp: str, value: str,
               numeric: bool = False) -> "Table":
        if cmp not in CMP_OPS:
            raise ValueError(f"bad cmp {cmp!r} (want one of {CMP_OPS})")
        _col_index(self.schema, col)
        node = Node("filter", {"col": col, "cmp": cmp, "value": str(value),
                               "numeric": bool(numeric)},
                    (self.plan,), self.schema)
        return Table(node)

    def project(self, columns: Sequence[str]) -> "Table":
        for c in columns:
            _col_index(self.schema, c)
        node = Node("project", {"columns": list(columns)},
                    (self.plan,), tuple(columns))
        return Table(node)

    # -- joins ---------------------------------------------------------

    def _join(self, other: "Table", left_key: str, right_key: str,
              how: str, strategy: str) -> "Table":
        if how not in JOIN_HOW:
            raise ValueError(f"bad join how {how!r}")
        _col_index(self.schema, left_key)
        _col_index(other.schema, right_key)
        if how == "inner":
            schema = tuple(self.schema) + tuple(
                c for c in other.schema if c != right_key)
        elif how == "semi":
            schema = tuple(self.schema)
        else:  # semi_distinct: just the join key, one row per match
            schema = (left_key,)
        node = Node("join", {"left_key": left_key, "right_key": right_key,
                             "how": how, "strategy": strategy},
                    (self.plan, other.plan), schema)
        return Table(node)

    def join(self, other: "Table", left_key: str,
             right_key: Optional[str] = None, how: str = "inner") -> "Table":
        """Strategy chosen by the planner (stats vs
        tez.query.broadcast.max-mb, then PlanFeedback)."""
        return self._join(other, left_key, right_key or left_key,
                          how, "auto")

    def hash_join(self, other: "Table", left_key: str,
                  right_key: Optional[str] = None,
                  how: str = "inner") -> "Table":
        """Pin the broadcast hash strategy (build side = ``other``)."""
        return self._join(other, left_key, right_key or left_key,
                          how, "broadcast")

    def sort_merge_join(self, other: "Table", left_key: str,
                        right_key: Optional[str] = None,
                        how: str = "inner") -> "Table":
        """Pin the repartition sort-merge strategy."""
        return self._join(other, left_key, right_key or left_key,
                          how, "repartition")

    # -- shuffles ------------------------------------------------------

    def aggregate(self, keys: Sequence[str],
                  aggs: Sequence[Tuple[str, str, str]]) -> "Table":
        """``aggs`` = [(out_col, fn, in_col)] with fn in count/sum/min/
        max over integer-parsed columns; empty aggs = DISTINCT keys."""
        for k in keys:
            _col_index(self.schema, k)
        for out, fn, col in aggs:
            if fn not in AGG_FNS:
                raise ValueError(f"bad agg fn {fn!r}")
            if fn != "count":
                _col_index(self.schema, col)
        node = Node("aggregate",
                    {"keys": list(keys),
                     "aggs": [[o, f, c] for o, f, c in aggs]},
                    (self.plan,),
                    tuple(keys) + tuple(o for o, _f, _c in aggs))
        return Table(node)

    def window(self, partition: str, order: str, func: str = "row_number",
               out_col: str = "w_rank") -> "Table":
        """Per-partition window over rows ordered lexicographically by
        ``order`` (ties broken by the full row)."""
        if func not in WINDOW_FNS:
            raise ValueError(f"bad window fn {func!r}")
        _col_index(self.schema, partition)
        _col_index(self.schema, order)
        node = Node("window", {"partition": partition, "order": order,
                               "func": func, "out_col": out_col},
                    (self.plan,), tuple(self.schema) + (out_col,))
        return Table(node)

    def limit(self, n: int, order: Sequence[str]) -> "Table":
        """Global top-``n`` by lexicographic ``order`` columns (ties by
        full row) — a single-reducer funnel, deterministic by design."""
        for c in order:
            _col_index(self.schema, c)
        node = Node("limit", {"n": int(n), "order": list(order)},
                    (self.plan,), self.schema)
        return Table(node)
