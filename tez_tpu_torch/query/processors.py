"""Runtime operators for lowered query stages.

One vertex = one *stage*: a fused chain of row ops fed by either a text
source (pipeline), a pair of key-sorted grouped edges (sort-merge join),
or one grouped edge (aggregate / window / limit).  The stage payload is
plain JSON assembled by the planner — column references are resolved to
indexes at plan time, so the runtime never sees a schema.

Rows travel edges as ``key = key-column bytes`` / ``value = '|'-joined
row`` ("bytes" serdes); byte order of keys is exactly the lexicographic
order the logical layer promises, so grouped ordered edges give the
sort-merge/window/limit operators their ordering for free.

Every edge emit can drop a per-task qstats JSON (records + per-partition
bytes, partitioned with the same FNV-1a hash the runtime partitioner
uses) into ``tez.query.stats.dir`` — the observed-size side channel
PlanFeedback replans from (docs/query.md).

The port's copy of tez_tpu.query.processors: the operators are per-row
host code as in tez_tpu; the ordered edges they read and write sort,
partition and merge on the task's device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from tez_tpu_torch.api.runtime import LogicalInput, LogicalOutput
from tez_tpu_torch.library.partitioners import _stable_hash
from tez_tpu_torch.library.processors import SimpleProcessor

Row = Tuple[str, ...]


def decode_row(value: bytes) -> Row:
    return tuple(value.decode("utf-8").split("|"))


def encode_row(row: Row) -> bytes:
    return "|".join(row).encode("utf-8")


# -- row ops ----------------------------------------------------------------

def _cmp(cmp: str, lhs: str, rhs: str, numeric: bool) -> bool:
    if cmp == "contains":
        return rhs in lhs
    a: Any
    b: Any
    if numeric:
        a, b = int(lhs), int(rhs)
    else:
        a, b = lhs, rhs
    return {"eq": a == b, "ne": a != b, "lt": a < b,
            "le": a <= b, "gt": a > b, "ge": a >= b}[cmp]


def apply_ops(row: Row, ops: List[Dict[str, Any]],
              builds: Dict[str, Dict[str, Any]]) -> List[Row]:
    """Run the fused op chain over one row; hash-join ops fan out."""
    rows = [row]
    for op in ops:
        kind = op["op"]
        if kind == "filter":
            rows = [r for r in rows
                    if _cmp(op["cmp"], r[op["idx"]], op["value"],
                            op["numeric"])]
        elif kind == "project":
            idxs = op["idxs"]
            rows = [tuple(r[i] for i in idxs) for r in rows]
        elif kind == "hash_join":
            table = builds[op["build"]]
            key_idx, how, keep = op["key_idx"], op["how"], op["keep"]
            out: List[Row] = []
            for r in rows:
                matches = table.get(r[key_idx])
                if not matches:
                    continue
                if how == "semi":
                    out.append(r)
                else:  # inner
                    for br in matches:
                        out.append(tuple(r) + tuple(br[i] for i in keep))
            rows = out
        else:
            raise ValueError(f"unknown op {kind!r}")
        if not rows:
            break
    return rows


def load_build_side(reader: Any) -> Dict[str, List[Row]]:
    """Materialize a broadcast build input: key -> rows."""
    table: Dict[str, List[Row]] = {}
    for k, v in reader:
        key = k.decode("utf-8") if isinstance(k, (bytes, bytearray)) else str(k)
        table.setdefault(key, []).append(decode_row(bytes(v)))
    return table


# -- emitters ---------------------------------------------------------------

class _Stats:
    """Per-task qstats accumulator for one outgoing exchange."""

    def __init__(self, spec: Dict[str, Any], vertex: str, task: int):
        self.spec, self.vertex, self.task = spec, vertex, task
        self.partitions = [0] * max(1, int(spec.get("partitions", 1)))
        self.records = 0

    def record(self, key: bytes, nbytes: int) -> None:
        part = _stable_hash(key) % len(self.partitions)
        self.partitions[part] += nbytes
        self.records += 1

    def flush(self) -> None:
        d = self.spec["dir"]
        os.makedirs(d, exist_ok=True)
        name = (f"{self.spec['node']}_{self.spec['role']}_"
                f"{self.vertex}_{self.task:05d}.json")
        tmp = os.path.join(d, "." + name + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"node": self.spec["node"], "role": self.spec["role"],
                       "vertex": self.vertex, "task": self.task,
                       "records": self.records,
                       "partitions": self.partitions}, f)
        os.replace(tmp, os.path.join(d, name))


class _EdgeEmit:
    def __init__(self, spec: Dict[str, Any], outputs: Dict[str, LogicalOutput],
                 vertex: str, task: int):
        out = spec["output"]
        if not out:
            # broadcast build side: its consumer's vertex name wasn't
            # known at plan time, but a build stage has exactly one output
            (out,) = outputs.keys()
        self.writer = outputs[out].get_writer()
        self.key_idx = spec["key_idx"]
        self.stats: Optional[_Stats] = None
        if spec.get("stats"):
            st = dict(spec["stats"])
            st["partitions"] = spec.get("partitions", 1)
            self.stats = _Stats(st, vertex, task)

    def write(self, row: Row) -> None:
        key = row[self.key_idx].encode("utf-8")
        value = encode_row(row)
        self.writer.write(key, value)
        if self.stats is not None:
            self.stats.record(key, len(key) + len(value))

    def finish(self) -> None:
        if self.stats is not None:
            self.stats.flush()


class _AggEdgeEmit:
    """Map-side partial aggregation (the combiner analog): accumulate
    per group key, emit one partial row per key at finish."""

    def __init__(self, spec: Dict[str, Any], outputs: Dict[str, LogicalOutput],
                 vertex: str, task: int):
        self.writer = outputs[spec["output"]].get_writer()
        self.key_idxs = spec["key_idxs"]
        self.aggs = spec["aggs"]  # [[fn, idx], ...]
        self.acc: Dict[Tuple[str, ...], List[int]] = {}
        self.stats: Optional[_Stats] = None
        if spec.get("stats"):
            st = dict(spec["stats"])
            st["partitions"] = spec.get("partitions", 1)
            self.stats = _Stats(st, vertex, task)

    def write(self, row: Row) -> None:
        key = tuple(row[i] for i in self.key_idxs)
        acc = self.acc.get(key)
        if acc is None:
            self.acc[key] = [
                1 if fn == "count" else int(row[idx])
                for fn, idx in self.aggs]
            return
        for slot, (fn, idx) in enumerate(self.aggs):
            if fn == "count":
                acc[slot] += 1
            elif fn == "sum":
                acc[slot] += int(row[idx])
            elif fn == "min":
                acc[slot] = min(acc[slot], int(row[idx]))
            else:
                acc[slot] = max(acc[slot], int(row[idx]))

    def finish(self) -> None:
        for key in sorted(self.acc):
            row = key + tuple(str(v) for v in self.acc[key])
            kb = "|".join(key).encode("utf-8")
            vb = encode_row(row)
            self.writer.write(kb, vb)
            if self.stats is not None:
                self.stats.record(kb, len(kb) + len(vb))
        if self.stats is not None:
            self.stats.flush()


class _SinkEmit:
    def __init__(self, spec: Dict[str, Any],
                 outputs: Dict[str, LogicalOutput]):
        self.writer = outputs[spec["output"]].get_writer()
        self.key_idx = spec["key_idx"]
        self.value_idxs = spec["value_idxs"]
        self.literal = spec.get("literal")

    def write(self, row: Row) -> None:
        if self.literal is not None:
            value = self.literal
        else:
            value = "|".join(row[i] for i in self.value_idxs)
        self.writer.write(row[self.key_idx], value)

    def finish(self) -> None:
        pass


def _make_emit(payload: Dict[str, Any], outputs: Dict[str, LogicalOutput],
               vertex: str, task: int):
    spec = payload["emit"]
    kind = spec["kind"]
    if kind == "edge":
        return _EdgeEmit(spec, outputs, vertex, task)
    if kind == "agg_edge":
        return _AggEdgeEmit(spec, outputs, vertex, task)
    if kind == "sink":
        return _SinkEmit(spec, outputs)
    raise ValueError(f"unknown emit kind {kind!r}")


# -- stage processors -------------------------------------------------------

class _QueryProcessor(SimpleProcessor):
    """Shared scaffolding: payload, broadcast build sides, emitter."""

    def _setup(self, inputs: Dict[str, LogicalInput],
               outputs: Dict[str, LogicalOutput]):
        payload = self.context.user_payload.load() or {}
        builds = {
            op["build"]: load_build_side(inputs[op["build"]].get_reader())
            for op in payload.get("ops", []) if op["op"] == "hash_join"}
        emit = _make_emit(payload, outputs, self.context.vertex_name,
                          self.context.task_index)
        return payload, builds, emit


class QueryPipelineProcessor(_QueryProcessor):
    """Text source -> fused ops (filter/project/broadcast hash join) ->
    emit.  The scan stage of every plan."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload, builds, emit = self._setup(inputs, outputs)
        src = payload["source"]
        mode, delim = src["mode"], src.get("delimiter", "|")
        ops = payload.get("ops", [])
        reader = inputs[src.get("input", "input")].get_reader()
        for _offset, line in reader:
            text = line.decode("utf-8")
            if mode == "table":
                text = text.rstrip("\r\n")
                if not text:
                    continue
                rows = [tuple(text.split(delim))]
            elif mode == "lines":
                text = text.strip()
                if not text:
                    continue
                rows = [(text,)]
            else:  # words
                rows = [(w,) for w in text.split()]
            for row in rows:
                for out in apply_ops(row, ops, builds):
                    emit.write(out)
        emit.finish()


class QuerySortMergeJoinProcessor(_QueryProcessor):
    """Lockstep merge of two key-sorted grouped inputs (the repartition
    strategy).  ``how``: inner = per-pair fan-out, semi = every left row
    of a matching key, semi_distinct = the key once."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload, builds, emit = self._setup(inputs, outputs)
        how = payload["how"]
        keep = payload.get("right_keep", [])
        ops = payload.get("ops", [])
        left = iter(inputs[payload["left_input"]].get_reader())
        right = iter(inputs[payload["right_input"]].get_reader())

        def nxt(it):
            try:
                k, vs = next(it)
                return bytes(k), vs
            except StopIteration:
                return None, None

        lk, lvs = nxt(left)
        rk, rvs = nxt(right)
        while lk is not None and rk is not None:
            if lk == rk:
                lrows = sorted(decode_row(bytes(v)) for v in lvs)
                if how == "semi_distinct":
                    outs: List[Row] = [(lk.decode("utf-8"),)]
                elif how == "semi":
                    outs = lrows
                else:
                    rrows = sorted(decode_row(bytes(v)) for v in rvs)
                    outs = [lr + tuple(rr[i] for i in keep)
                            for lr in lrows for rr in rrows]
                for row in outs:
                    for out in apply_ops(row, ops, builds):
                        emit.write(out)
                lk, lvs = nxt(left)
                rk, rvs = nxt(right)
            elif lk < rk:
                lk, lvs = nxt(left)
            else:
                rk, rvs = nxt(right)
        emit.finish()


class QueryAggregateProcessor(_QueryProcessor):
    """Final aggregation over grouped partial rows (value layout:
    key columns + one partial per agg)."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload, builds, emit = self._setup(inputs, outputs)
        width = payload["key_width"]
        aggs = payload["aggs"]  # [fn, ...] merge functions by slot
        ops = payload.get("ops", [])
        for k, vs in inputs[payload["agg_input"]].get_reader():
            finals: Optional[List[int]] = None
            key_cols: Row = ()
            for v in vs:
                row = decode_row(bytes(v))
                key_cols = row[:width]
                partials = [int(x) for x in row[width:]]
                if finals is None:
                    finals = partials
                    continue
                for slot, fn in enumerate(aggs):
                    if fn in ("count", "sum"):
                        finals[slot] += partials[slot]
                    elif fn == "min":
                        finals[slot] = min(finals[slot], partials[slot])
                    else:
                        finals[slot] = max(finals[slot], partials[slot])
            row = key_cols + tuple(str(v) for v in (finals or []))
            for out in apply_ops(row, ops, builds):
                emit.write(out)
        emit.finish()


class QueryWindowProcessor(_QueryProcessor):
    """Per-partition window: rows of each key group sorted by the order
    column (ties by full row), then row_number / cume_sum appended."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload, builds, emit = self._setup(inputs, outputs)
        order_idx = payload["order_idx"]
        func = payload["func"]
        ops = payload.get("ops", [])
        for _k, vs in inputs[payload["win_input"]].get_reader():
            rows = sorted((decode_row(bytes(v)) for v in vs),
                          key=lambda r: (r[order_idx], r))
            running = 0
            for i, row in enumerate(rows):
                if func == "row_number":
                    tagged = row + (str(i + 1),)
                else:  # cume_sum
                    running += int(row[order_idx])
                    tagged = row + (str(running),)
                for out in apply_ops(tagged, ops, builds):
                    emit.write(out)
        emit.finish()


class QueryLimitProcessor(_QueryProcessor):
    """Global top-n funnel: single consumer of a 1-partition ordered
    edge keyed by the first order column; the rows of each key group are
    ordered by the other order columns (``then_by``), ties by the full
    row; stops after n rows."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        payload, builds, emit = self._setup(inputs, outputs)
        n = payload["n"]
        then_by = payload.get("then_by", [])
        ops = payload.get("ops", [])
        taken = 0
        for _k, vs in inputs[payload["limit_input"]].get_reader():
            if taken >= n:
                break
            rows = sorted((decode_row(bytes(v)) for v in vs),
                          key=lambda r: (tuple(r[i] for i in then_by), r))
            for row in rows:
                if taken >= n:
                    break
                taken += 1
                for out in apply_ops(row, ops, builds):
                    emit.write(out)
        emit.finish()
