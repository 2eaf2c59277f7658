"""Deterministic TPC-H-style corpus + numpy reference oracle.

Four tables (customer/orders/lineitem/part) with zero-padded numeric
columns (so lexicographic order == numeric order, the ordering contract
of the query layer) and seeded foreign keys — uniform by default, Zipf-
skewed when ``skew > 0`` (hot join/group keys, the shape the skew-replan
path exists for).  The same seed always writes byte-identical .tbl
files.

``CORPUS_QUERIES`` is the fixed query suite: every relational operator
(scan/filter/project/hash_join/sort_merge_join/auto join/aggregate/
window/limit/semi joins) is covered, and every query carries a numpy
oracle producing the exact sorted (key, value) records the DAG must
emit — bit-exact under ANY physical strategy, which is what makes
strategy flips safe to automate.

The port's copy of tez_tpu.tools.query_corpus: the same seed writes the
same bytes as tez_tpu's generator, and the oracles are the same numpy
code.  chip_smoke.py's phase 18 runs the suite on the card at scale 100.

CLI: ``python -m tez_tpu_torch.tools.query_corpus OUTDIR [--scale S]
[--skew Z] [--seed N]`` writes the tables and prints a manifest line per
table.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from tez_tpu_torch.query.logical import Table

#: rows per table at scale 1.0
_BASE_ROWS = {"customer": 150, "orders": 1500, "lineitem": 6000,
              "part": 200}

SCHEMAS: Dict[str, List[str]] = {
    "customer": ["c_custkey", "c_name", "c_nation"],
    "orders": ["o_orderkey", "o_custkey", "o_total"],
    "lineitem": ["l_orderkey", "l_partkey", "l_qty", "l_price", "l_flag"],
    "part": ["p_partkey", "p_name", "p_brand"],
}


def _fk_indices(rng: np.random.Generator, n: int, domain: int,
                skew: float) -> np.ndarray:
    """``n`` foreign-key indices into [0, domain).  skew=0 -> uniform;
    skew>0 -> Zipf-ish weights 1/(i+1)**skew (index 0 hottest)."""
    if skew <= 0.0:
        return rng.integers(0, domain, size=n)
    weights = 1.0 / np.power(np.arange(1, domain + 1, dtype=np.float64),
                             skew)
    cum = np.cumsum(weights / weights.sum())
    return np.searchsorted(cum, rng.random(n), side="left").clip(
        0, domain - 1)


@dataclasses.dataclass
class Corpus:
    """Generated corpus: table paths + schemas + cached numpy columns."""
    workdir: str
    scale: float
    skew: float
    seed: int
    paths: Dict[str, str]
    _cache: Dict[str, Dict[str, np.ndarray]] = \
        dataclasses.field(default_factory=dict)

    def scan(self, table: str) -> Table:
        return Table.scan(table, [self.paths[table]], SCHEMAS[table])

    def columns(self, table: str) -> Dict[str, np.ndarray]:
        """Parse a .tbl back into {column: np str array} (oracle input —
        the files on disk are the single source of truth)."""
        if table not in self._cache:
            with open(self.paths[table]) as f:
                rows = [line.rstrip("\n").split("|")
                        for line in f if line.strip()]
            cols = SCHEMAS[table]
            arr = np.array(rows, dtype=str) if rows else \
                np.empty((0, len(cols)), dtype=str)
            self._cache[table] = {c: arr[:, i]
                                  for i, c in enumerate(cols)}
        return self._cache[table]


def generate(workdir: str, scale: float = 1.0, skew: float = 0.0,
             seed: int = 0) -> Corpus:
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_cust = max(3, int(_BASE_ROWS["customer"] * scale))
    n_ord = max(6, int(_BASE_ROWS["orders"] * scale))
    n_li = max(12, int(_BASE_ROWS["lineitem"] * scale))
    n_part = max(3, int(_BASE_ROWS["part"] * scale))
    paths = {t: os.path.join(workdir, f"{t}.tbl") for t in SCHEMAS}

    with open(paths["customer"], "w") as f:
        for i in range(n_cust):
            f.write(f"c{i:06d}|name{i:06d}|n{i % 17:02d}\n")

    o_cust = _fk_indices(rng, n_ord, n_cust, skew)
    o_total = rng.integers(0, 100000, size=n_ord)
    with open(paths["orders"], "w") as f:
        for i in range(n_ord):
            f.write(f"o{i:07d}|c{o_cust[i]:06d}|{o_total[i]:08d}\n")

    with open(paths["part"], "w") as f:
        for i in range(n_part):
            f.write(f"p{i:06d}|part{i:06d}|b{i % 25:02d}\n")

    l_ord = _fk_indices(rng, n_li, n_ord, skew)
    l_part = _fk_indices(rng, n_li, n_part, skew)
    l_qty = rng.integers(0, 51, size=n_li)
    l_price = rng.integers(1, 1000000, size=n_li)
    flags = np.array(["A", "N", "R"])
    l_flag = flags[rng.integers(0, 3, size=n_li)]
    with open(paths["lineitem"], "w") as f:
        for i in range(n_li):
            f.write(f"o{l_ord[i]:07d}|p{l_part[i]:06d}|{l_qty[i]:04d}|"
                    f"{l_price[i]:07d}|{l_flag[i]}\n")

    return Corpus(workdir=workdir, scale=scale, skew=skew, seed=seed,
                  paths=paths)


# -- numpy oracle helpers ---------------------------------------------------

def _group_agg(keys: np.ndarray, aggs: List[Tuple[str, np.ndarray]]
               ) -> Dict[str, List[int]]:
    """Group-by over string keys -> {key: [agg values in order]} using
    np.unique inverse indexes + ufunc.at accumulation."""
    if keys.size == 0:
        return {}
    uniq, inv = np.unique(keys, return_inverse=True)
    out: Dict[str, List[int]] = {k: [] for k in uniq}
    for fn, col in aggs:
        if fn == "count":
            vals = np.bincount(inv, minlength=len(uniq))
        elif fn == "sum":
            vals = np.zeros(len(uniq), dtype=np.int64)
            np.add.at(vals, inv, col.astype(np.int64))
        elif fn == "min":
            vals = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
            np.minimum.at(vals, inv, col.astype(np.int64))
        else:  # max
            vals = np.full(len(uniq), np.iinfo(np.int64).min, np.int64)
            np.maximum.at(vals, inv, col.astype(np.int64))
        for i, k in enumerate(uniq):
            out[str(k)].append(int(vals[i]))
    return out


def _records(rows: Dict[str, List[int]]) -> List[Tuple[str, str]]:
    return sorted((k, "|".join(str(v) for v in vals))
                  for k, vals in rows.items())


def _join_map(keys: np.ndarray, *cols: np.ndarray) -> Dict[str, List[Tuple]]:
    out: Dict[str, List[Tuple]] = {}
    for i in range(keys.size):
        out.setdefault(str(keys[i]), []).append(
            tuple(str(c[i]) for c in cols))
    return out


# -- the corpus query suite -------------------------------------------------

@dataclasses.dataclass
class CorpusQuery:
    name: str
    build: Callable[[Corpus], Table]
    oracle: Callable[[Corpus], List[Tuple[str, str]]]
    sink: Optional[Dict[str, Any]] = None
    #: queries whose physical strategy the planner may choose/replan
    strategy_sensitive: bool = False


def _q_pricing(c: Corpus) -> Table:
    return (c.scan("lineitem")
            .filter("l_qty", "ge", "0025", numeric=True)
            .aggregate(["l_flag"], [("sum_price", "sum", "l_price"),
                                    ("n", "count", "l_orderkey"),
                                    ("max_qty", "max", "l_qty")]))


def _o_pricing(c: Corpus) -> List[Tuple[str, str]]:
    li = c.columns("lineitem")
    sel = li["l_qty"].astype(int) >= 25
    return _records(_group_agg(
        li["l_flag"][sel],
        [("sum", li["l_price"][sel]), ("count", li["l_price"][sel]),
         ("max", li["l_qty"][sel])]))


def _q_nation_revenue(c: Corpus) -> Table:
    return (c.scan("orders")
            .join(c.scan("customer"), "o_custkey", "c_custkey")
            .aggregate(["c_nation"], [("revenue", "sum", "o_total"),
                                      ("n", "count", "o_orderkey")]))


def _o_nation_revenue(c: Corpus) -> List[Tuple[str, str]]:
    o, cu = c.columns("orders"), c.columns("customer")
    cust = _join_map(cu["c_custkey"], cu["c_nation"])
    nations, totals = [], []
    for i in range(o["o_orderkey"].size):
        for (nation,) in cust.get(str(o["o_custkey"][i]), []):
            nations.append(nation)
            totals.append(int(o["o_total"][i]))
    nk = np.array(nations, dtype=str)
    tv = np.array(totals, dtype=np.int64)
    return _records(_group_agg(nk, [("sum", tv), ("count", tv)]))


def _q_supply_chain(c: Corpus) -> Table:
    """Multi-join tree: repartition-pinned big-big join, aggregate,
    then a broadcast-pinned dim join, aggregate again."""
    per_cust = (c.scan("lineitem")
                .sort_merge_join(c.scan("orders"), "l_orderkey",
                                 "o_orderkey")
                .aggregate(["o_custkey"], [("rev", "sum", "l_price")]))
    return (per_cust
            .hash_join(c.scan("customer"), "o_custkey", "c_custkey")
            .aggregate(["c_nation"], [("revenue", "sum", "rev"),
                                      ("n", "count", "o_custkey")]))


def _o_supply_chain(c: Corpus) -> List[Tuple[str, str]]:
    li, o, cu = (c.columns("lineitem"), c.columns("orders"),
                 c.columns("customer"))
    orders = _join_map(o["o_orderkey"], o["o_custkey"])
    per_cust: Dict[str, int] = {}
    for i in range(li["l_orderkey"].size):
        for (custkey,) in orders.get(str(li["l_orderkey"][i]), []):
            per_cust[custkey] = per_cust.get(custkey, 0) + \
                int(li["l_price"][i])
    nation_of = {str(k): str(n) for k, n in
                 zip(cu["c_custkey"], cu["c_nation"])}
    agg: Dict[str, List[int]] = {}
    for custkey in sorted(per_cust):
        nation = nation_of.get(custkey)
        if nation is None:
            continue
        cur = agg.setdefault(nation, [0, 0])
        cur[0] += per_cust[custkey]
        cur[1] += 1
    return _records(agg)


def _q_top_orders(c: Corpus) -> Table:
    return (c.scan("orders")
            .window("o_custkey", "o_total", "row_number", "w_rank")
            .filter("w_rank", "le", "3", numeric=True)
            .project(["o_custkey", "o_orderkey", "w_rank"]))


def _o_top_orders(c: Corpus) -> List[Tuple[str, str]]:
    o = c.columns("orders")
    by_cust: Dict[str, List[Tuple[str, ...]]] = {}
    for i in range(o["o_orderkey"].size):
        row = (str(o["o_orderkey"][i]), str(o["o_custkey"][i]),
               str(o["o_total"][i]))
        by_cust.setdefault(row[1], []).append(row)
    out: List[Tuple[str, str]] = []
    for custkey, rows in by_cust.items():
        rows.sort(key=lambda r: (r[2], r))   # order col, ties by full row
        for rank, row in enumerate(rows[:3], 1):
            out.append((custkey, f"{row[0]}|{rank}"))
    return sorted(out)


def _q_hot_parts(c: Corpus) -> Table:
    return (c.scan("lineitem")
            .filter("l_qty", "ge", "0045", numeric=True)
            .join(c.scan("part"), "l_partkey", "p_partkey",
                  how="semi_distinct"))


def _o_hot_parts(c: Corpus) -> List[Tuple[str, str]]:
    li, p = c.columns("lineitem"), c.columns("part")
    sel = li["l_qty"].astype(int) >= 45
    parts = set(str(k) for k in p["p_partkey"])
    keys = sorted(set(str(k) for k in li["l_partkey"][sel]) & parts)
    return [(k, "") for k in keys]


def _q_flagged_sample(c: Corpus) -> Table:
    return (c.scan("lineitem")
            .filter("l_flag", "eq", "A")
            .project(["l_partkey", "l_price", "l_orderkey"])
            .limit(20, ["l_partkey"]))


def _o_flagged_sample(c: Corpus) -> List[Tuple[str, str]]:
    li = c.columns("lineitem")
    sel = li["l_flag"] == "A"
    rows = sorted(
        (str(pk), str(pr), str(ok)) for pk, pr, ok in
        zip(li["l_partkey"][sel], li["l_price"][sel],
            li["l_orderkey"][sel]))
    return sorted((r[0], f"{r[1]}|{r[2]}") for r in rows[:20])


def _q_local_orders(c: Corpus) -> Table:
    return (c.scan("orders")
            .hash_join(c.scan("customer").filter("c_nation", "eq", "n03"),
                       "o_custkey", "c_custkey", how="semi")
            .project(["o_orderkey", "o_custkey"]))


def _o_local_orders(c: Corpus) -> List[Tuple[str, str]]:
    o, cu = c.columns("orders"), c.columns("customer")
    local = set(str(k) for k, n in zip(cu["c_custkey"], cu["c_nation"])
                if str(n) == "n03")
    return sorted((str(ok), str(ck)) for ok, ck in
                  zip(o["o_orderkey"], o["o_custkey"])
                  if str(ck) in local)


CORPUS_QUERIES: List[CorpusQuery] = [
    CorpusQuery("pricing_summary", _q_pricing, _o_pricing),
    CorpusQuery("nation_revenue", _q_nation_revenue, _o_nation_revenue,
                strategy_sensitive=True),
    CorpusQuery("supply_chain", _q_supply_chain, _o_supply_chain),
    CorpusQuery("top_orders", _q_top_orders, _o_top_orders),
    CorpusQuery("hot_parts", _q_hot_parts, _o_hot_parts),
    CorpusQuery("flagged_sample", _q_flagged_sample, _o_flagged_sample),
    CorpusQuery("local_orders", _q_local_orders, _o_local_orders),
]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="query_corpus",
        description="generate the deterministic TPC-H-style query corpus")
    ap.add_argument("outdir")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--skew", type=float, default=0.0,
                    help="Zipf exponent for foreign keys (0 = uniform)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    corpus = generate(args.outdir, scale=args.scale, skew=args.skew,
                      seed=args.seed)
    for table, path in sorted(corpus.paths.items()):
        print(f"{table}\t{os.path.getsize(path)}B\t{path}")
    print(f"queries\t{len(CORPUS_QUERIES)}\t"
          f"{','.join(q.name for q in CORPUS_QUERIES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
