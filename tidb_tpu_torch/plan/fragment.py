"""Join fragments: multi-table pushdown units for the TiTPU coprocessor.

The reference executes multi-table analytics by shipping plan fragments to
the columnar MPP tier — exchanges between TiFlash nodes, gathered by TiDB
(reference: planner/core/fragment.go:45 fragment expansion,
store/tikv/mpp.go:372 DispatchMPPTasks, executor/mpp_gather.go:103). The
TPU equivalent keeps whole snowflake join trees inside ONE fused device
program: dimension ("build") tables become device-resident lookup tables,
the fact ("probe") table streams through gather-joins, and the post-join
selection/aggregation reuses the single-table kernel machinery. On a
remote TPU every synchronous round trip costs ~100ms, so fusing the whole
join pipeline into one dispatch+fetch is the difference between one RTT
and five.

Eligibility (recognized bottom-up over the physical plan):

* INNER equi-joins only, one join key per edge;
* every table but one ("probe") is reachable through a join whose key on
  that table is unique — the PK handle or a single-column visible unique
  index — so each probe row matches at most one build row and the join is
  a static-shape gather (no dynamic output sizes for XLA);
* leaves are bare full scans (their pushed-down filters ride along and
  are applied to the build bitmaps);
* integer join keys (dictionary codes are per-table and don't unify).

Key density, int32 staging width, and MVCC overlay state are runtime
properties — the executor (copr/fragment.py) checks them per snapshot and
falls back to an equivalent host (numpy) fragment interpreter, never to a
different plan shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.field_type import FieldType, TypeKind
from .dag import DAGAggregation, DAGTopN
from .expr import AggDesc, Call, Col, Const, PlanExpr, ScalarSubq
from .physical import (
    PhysHashAgg,
    PhysHashJoin,
    PhysLimit,
    PhysProjection,
    PhysSelection,
    PhysSort,
    PhysTableRead,
    PhysicalPlan,
    _bare_scan,
    _partial_val_type,
    agg_pushable,
    expr_pushable,
)
from .schema import PlanSchema, ResultField


@dataclass
class FragTable:
    """One table of the fragment. col_offsets are store offsets in local
    column order; filters are this table's pushed-down conjuncts in LOCAL
    index space (Col.idx -> position in col_offsets)."""

    table: object  # TableInfo
    col_offsets: list[int]
    filters: list[PlanExpr] = field(default_factory=list)
    col_types: list[FieldType] = field(default_factory=list)


@dataclass
class FragJoin:
    """Gather-join of tables[build] onto the probe row stream.

    probe_key evaluates in the COMBINED column space of all previously
    placed tables; build_key_local indexes tables[build].col_offsets. The
    build key is unique per eligibility, so the join is
    idx = perm[key - lo]; found = idx >= 0."""

    build: int
    probe_key: PlanExpr
    build_key_local: int


@dataclass
class FragSemi:
    """Membership-gate edge (EXISTS / IN / NOT IN): probe-stream rows
    survive iff their key is (not) present in the build table's filtered
    key set. The build table contributes NO columns to the combined
    space — only a device-resident membership bitmap over its key span
    (copr/fragment.py stages it host-side per epoch, NULL-aware for the
    ANTI_NULL NOT-IN form). kind: "SEMI" | "ANTI" | "ANTI_NULL"."""

    table: FragTable
    probe_key: PlanExpr
    build_key_local: int
    kind: str


@dataclass
class HCTopN:
    """High-cardinality group-by hint: the aggregation's consumer is
    ORDER BY <score> LIMIT k, so the device may return only a candidate
    superset of the top-k groups (sorted-run kernel, copr/hcagg.py)
    instead of the full group set. score: ("group", j) ranks by group key
    j; ("agg", ai) ranks by aggregate ai's (approximate) value. The host
    layers above re-sort exactly.

    `items`, when set, is the COMPLETE resolved ORDER BY list
    [(kind, idx, desc), ...] with kind in ("group", "agg") — every item
    ranks by a group key or by an exactly-recombinable SUM/COUNT — and
    unlocks the fused final cut (copr/fragment.py `fat` mode,
    join+agg+topn): the device sorts the candidate buffer by the EXACT
    multi-key order (limb-pair digits for aggregates, rank tables for
    dictionary strings) so only the final k groups leave HBM. items[0]
    always matches `score`."""

    score: tuple[str, int]
    desc: bool
    k: int
    items: Optional[list] = None

    @property
    def cap(self) -> int:
        # candidate buffer absorbing f32 score ties near the k-th value
        return max(4 * self.k, self.k + 64)


@dataclass
class FragmentDAG:
    """tables[0] is the probe; joins place tables[1..] in order. The
    combined column space is concat(tables[i] columns) in table order;
    selection/agg/out_map all reference it."""

    tables: list[FragTable]
    joins: list[FragJoin]
    selection: list[PlanExpr] = field(default_factory=list)
    agg: Optional[DAGAggregation] = None
    # row mode: combined idx per output position (tree schema order)
    out_map: Optional[list[int]] = None
    output_types: list[FieldType] = field(default_factory=list)
    # row mode with a TopN consumer: sort items in COMBINED column space
    # + the limit — the device returns only the per-batch top n rows
    # (copr/fragment.py `topn` mode, join+topn); the host Sort/Limit
    # above merge the per-batch/tile/shard candidates exactly
    topn: Optional[DAGTopN] = None
    # set when the agg's consumer is a TopN: permits the high-cardinality
    # candidate path when the dense-segment gate rejects the group space
    hc: Optional[HCTopN] = None
    # set when the agg's consumer filters on an aggregate value (HAVING
    # sum(x) > c): the device may return only groups passing a safely
    # widened version of these predicates — the host Selection above
    # re-applies them exactly. Each entry is (agg_index, op, const) with
    # op in lt/le/gt/ge and const already scaled to the aggregate's
    # integer representation.
    having: Optional[list] = None
    # semi/anti membership gates applied after the joins (no columns)
    semis: list[FragSemi] = field(default_factory=list)
    HAVING_CAP = 65536  # candidate buffer for having/all-groups modes

    def combined_types(self) -> list[FieldType]:
        out: list[FieldType] = []
        for t in self.tables:
            out.extend(t.col_types)
        return out

    def describe(self) -> str:
        parts = [f"probe(t{self.tables[0].table.id} "
                 f"cols={self.tables[0].col_offsets})"]
        for j in self.joins:
            t = self.tables[j.build]
            parts.append(f"gather(t{t.table.id} key={j.probe_key!r})")
        for sm in self.semis:
            parts.append(f"{sm.kind.lower()}(t{sm.table.table.id} "
                         f"key={sm.probe_key!r})")
        if self.selection:
            parts.append(f"sel({len(self.selection)})")
        if self.agg is not None:
            parts.append(f"agg(groups={len(self.agg.group_by)}, "
                         f"aggs={self.agg.aggs})")
        if self.topn is not None:
            parts.append(f"topn({self.topn.n})")
        return " -> ".join(parts)


@dataclass
class PhysFragmentRead(PhysicalPlan):
    """Leaf executing a FragmentDAG on the coprocessor.

    Agg mode outputs the partial layout [group cols..., (val, cnt)...]
    merged by a PhysHashAgg("final") parent — identical contract to the
    single-table pushdown (PhysTableRead + dag.agg)."""

    frag: FragmentDAG
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)
    est_rows: Optional[float] = None


# ==================== recognition ====================

_FRAG_KEY_KINDS = (TypeKind.TINYINT, TypeKind.SMALLINT, TypeKind.INT,
                   TypeKind.BIGINT, TypeKind.YEAR)


def _has_subq(e: PlanExpr) -> bool:
    if isinstance(e, ScalarSubq):
        return True
    if isinstance(e, Call):
        return any(_has_subq(a) for a in e.args)
    return False


@dataclass
class _Collected:
    leaves: list[PhysTableRead]
    # tree-space equality edges (absolute positions over concat'd leaves)
    edges: list[tuple[int, int]]
    # tree-space residual conjuncts (join ON residue + selections above)
    conds: list[PlanExpr]
    width: int
    # semi/anti membership edges: (probe tree position, build leaf,
    # build scan-local key, kind) — build leaves contribute no columns
    semis: list[tuple[int, PhysTableRead, int, str]] = \
        field(default_factory=list)


def _semi_build_leaf(node: PhysicalPlan):
    """Bare-scan build side of a semi/anti join; a trailing plain-Col
    projection (the planner trims the subquery to its key column) is
    tolerated. Returns (leaf, right-schema idx -> scan-local idx) or
    None."""
    if not isinstance(node, PhysTableRead):
        return None
    dag = node.dag
    if dag.scan.table_id < 0 or dag.scan.ranges is not None or \
            dag.agg is not None or dag.topn is not None or \
            dag.limit is not None:
        return None
    if getattr(node, "table", None) is None:
        return None
    if dag.selection and any(_has_subq(c)
                             for c in dag.selection.conditions):
        return None
    projs = dag.projections

    def local_of(i: int) -> Optional[int]:
        if projs is None:
            return i
        if i < len(projs) and isinstance(projs[i], Col):
            return projs[i].idx
        return None

    return node, local_of


def _collect_join_tree(node: PhysicalPlan) -> Optional[_Collected]:
    """Flatten a tree of INNER hash joins over bare scans; positions are
    absolute over the concatenated leaf columns in tree order. Semi/anti
    joins whose build side is a bare scan fold into membership edges
    (the probe subtree keeps its column space — semi output schema IS
    the left schema)."""
    if isinstance(node, PhysSelection):
        inner = _collect_join_tree(node.children[0])
        if inner is None:
            return None
        if any(_has_subq(c) for c in node.conditions):
            return None
        inner.conds = inner.conds + list(node.conditions)
        return inner
    if isinstance(node, PhysHashJoin) and \
            node.kind in ("SEMI", "ANTI", "ANTI_NULL"):
        left = _collect_join_tree(node.children[0])
        if left is None:
            return None
        if len(node.eq_conditions) != 1 or node.other_conditions:
            return None  # per-pair residuals can't gate via a bitmap
        leaf = _semi_build_leaf(node.children[1])
        if leaf is None:
            return None
        tr, local_of = leaf
        li, ri = node.eq_conditions[0]
        blocal = local_of(ri)
        if blocal is None:
            return None
        # integer key domains on both sides (dict codes don't unify)
        bft = _scan_types(tr)[blocal]
        pft = _tree_pos_type(left, li)
        if pft is None or pft.kind not in _FRAG_KEY_KINDS or \
                bft.kind not in _FRAG_KEY_KINDS:
            return None
        left.semis = left.semis + [(li, tr, blocal, node.kind)]
        return left
    if isinstance(node, PhysHashJoin):
        # CROSS nodes appear when the planner stages a cartesian pair whose
        # linking equalities live higher in the tree (e.g. Q9's
        # part x nation); they contribute leaves, later edges key them
        if node.kind not in ("INNER", "CROSS"):
            return None
        left = _collect_join_tree(node.children[0])
        right = _collect_join_tree(node.children[1])
        if left is None or right is None:
            return None
        lw = left.width
        edges = list(left.edges)
        edges += [(a + lw, b + lw) for a, b in right.edges]
        edges += [(li, ri + lw) for li, ri in node.eq_conditions]
        conds = list(left.conds) + [
            _shift_expr(c, lw) for c in right.conds]
        if node.other_conditions:
            if any(_has_subq(c) for c in node.other_conditions):
                return None
            conds += list(node.other_conditions)
        semis = list(left.semis) + [
            (p + lw, tr, bl, kind) for p, tr, bl, kind in right.semis]
        return _Collected(left.leaves + right.leaves, edges, conds,
                          lw + right.width, semis)
    if isinstance(node, PhysTableRead):
        if not _bare_scan(node) or node.dag.scan.ranges is not None:
            return None
        table = getattr(node, "table", None)
        if table is None:
            return None
        return _Collected([node], [], [],
                          len(node.dag.scan.col_offsets))
    return None


def _tree_pos_type(col: _Collected, pos: int) -> Optional[FieldType]:
    """Field type at an absolute tree position over the concat'd leaves."""
    for tr in col.leaves:
        w = len(tr.dag.scan.col_offsets)
        if pos < w:
            return tr.dag.output_types[pos]
        pos -= w
    return None


def _shift_expr(e: PlanExpr, by: int) -> PlanExpr:
    if by == 0:
        return e
    if isinstance(e, Col):
        return Col(e.idx + by, e.ftype)
    if isinstance(e, Call):
        return Call(e.op, [_shift_expr(a, by) for a in e.args], e.ftype,
                    e.extra)
    return e


def _subst_cols(e: PlanExpr, exprs: list[PlanExpr]) -> PlanExpr:
    """Compose an expression over a projection's output with the
    projection itself (Col i -> exprs[i])."""
    if isinstance(e, Col):
        return exprs[e.idx]
    if isinstance(e, Call):
        return Call(e.op, [_subst_cols(a, exprs) for a in e.args], e.ftype,
                    e.extra)
    return e


def _remap_expr(e: PlanExpr, remap: list[int]) -> PlanExpr:
    if isinstance(e, Col):
        return Col(remap[e.idx], e.ftype)
    if isinstance(e, Call):
        return Call(e.op, [_remap_expr(a, remap) for a in e.args], e.ftype,
                    e.extra)
    return e


def _unique_key_offset(table, local_off: int) -> bool:
    """Is the column at store offset local_off a unique key of table?"""
    if table.pk_handle_offset == local_off:
        return True
    for ix in table.indices:
        if ix.unique and ix.visible and ix.col_offsets == [local_off]:
            return True
    return False


def _try_assemble(col: _Collected) -> Optional[tuple[FragmentDAG, list[int]]]:
    """Pick a probe and a build order; returns (frag, treepos->combined)."""
    leaves = col.leaves
    n = len(leaves)
    if n < 2 and not col.semis:
        return None
    # leaf index + local position for every tree position
    leaf_of: list[tuple[int, int]] = []
    for i, tr in enumerate(leaves):
        for local in range(len(tr.dag.scan.col_offsets)):
            leaf_of.append((i, local))

    def leaf_field_type(i: int, local: int) -> FieldType:
        return leaves[i].dag.output_types[local]

    def key_ok(i: int, local: int) -> bool:
        off = leaves[i].dag.scan.col_offsets[local]
        ft = leaf_field_type(i, local)
        return ft.kind in _FRAG_KEY_KINDS and \
            _unique_key_offset(leaves[i].table, off)

    # candidates: prefer leaves that are never on a unique side (fact
    # tables), then larger estimated scans
    def probe_rank(i: int) -> tuple:
        never_unique = not any(
            (leaf_of[a][0] == i and key_ok(*leaf_of[a]))
            or (leaf_of[b][0] == i and key_ok(*leaf_of[b]))
            for a, b in col.edges)
        est = leaves[i].est_rows or 0.0
        return (0 if never_unique else 1, -est)

    for probe in sorted(range(n), key=probe_rank):
        placed = [probe]
        joins_plan: list[tuple[int, int, int]] = []  # (leaf, keypos, local)
        used_edges: set[int] = set()
        while len(placed) < n:
            advanced = False
            for ei, (a, b) in enumerate(col.edges):
                if ei in used_edges:
                    continue
                for probe_pos, build_pos in ((a, b), (b, a)):
                    pi, _ = leaf_of[probe_pos]
                    bi, blocal = leaf_of[build_pos]
                    if pi not in placed or bi in placed:
                        continue
                    if not key_ok(bi, blocal):
                        continue
                    pft = leaf_field_type(*leaf_of[probe_pos])
                    if pft.kind not in _FRAG_KEY_KINDS:
                        continue
                    placed.append(bi)
                    joins_plan.append((bi, probe_pos, blocal))
                    used_edges.add(ei)
                    advanced = True
                    break
                if advanced:
                    break
            if not advanced:
                break
        if len(placed) < n:
            continue

        # combined layout: placement order
        base_of_leaf: dict[int, int] = {}
        acc = 0
        for li in placed:
            base_of_leaf[li] = acc
            acc += len(leaves[li].dag.scan.col_offsets)
        remap = [base_of_leaf[leaf_of[p][0]] + leaf_of[p][1]
                 for p in range(col.width)]

        tables = []
        order_index = {li: k for k, li in enumerate(placed)}
        for li in placed:
            tr = leaves[li]
            filters = list(tr.dag.selection.conditions) \
                if tr.dag.selection else []
            tables.append(FragTable(
                tr.table, list(tr.dag.scan.col_offsets), filters,
                list(tr.dag.output_types)))
        joins = []
        for bi, probe_pos, blocal in joins_plan:
            joins.append(FragJoin(
                order_index[bi],
                Col(remap[probe_pos], leaf_field_type(*leaf_of[probe_pos])),
                blocal))
        # unused equality edges become plain selection conditions
        extra = []
        for ei, (a, b) in enumerate(col.edges):
            if ei not in used_edges:
                fa = leaf_field_type(*leaf_of[a])
                extra.append(Call("eq", [
                    Col(remap[a], fa), Col(remap[b], leaf_field_type(
                        *leaf_of[b]))], FieldType(TypeKind.BOOLEAN)))
        selection = [_remap_expr(c, remap) for c in col.conds] + extra
        frag = FragmentDAG(tables, joins, selection)
        for ppos, tr, blocal, kind in col.semis:
            frag.semis.append(FragSemi(
                FragTable(tr.table, list(tr.dag.scan.col_offsets),
                          list(tr.dag.selection.conditions)
                          if tr.dag.selection else [], _scan_types(tr)),
                Col(remap[ppos], leaf_field_type(*leaf_of[ppos])),
                blocal, kind))
        return frag, remap
    return None


def _match_agg_fragment(plan: PhysHashAgg, allow_single: bool = False
                        ) -> Optional[PhysHashAgg]:
    """HashAgg(complete) over [Projection?] over join tree -> final agg
    over a fragment read. allow_single admits one bare scan as a
    degenerate fragment (useful only with an hc TopN hint)."""
    # a projection between agg and joins (e.g. Q9's amount column)
    # composes into the agg expressions instead of blocking the match
    child = plan.children[0]
    proj = None
    if isinstance(child, PhysProjection) and \
            all(not _has_subq(e) for e in child.exprs):
        proj = child.exprs
        child = child.children[0]
    group_by = plan.group_by
    aggs = plan.aggs
    if proj is not None:
        group_by = [_subst_cols(g, proj) for g in group_by]
        aggs = [AggDesc(d.func,
                        None if d.arg is None else _subst_cols(d.arg, proj),
                        d.ftype, d.distinct, d.name, d.params)
                for d in plan.aggs]
    col = _collect_join_tree(child)
    if col is None or not agg_pushable(group_by, aggs) \
            or any(d.distinct for d in plan.aggs) \
            or any(d.func == "approx_count_distinct" for d in aggs):
        # hll sketches don't flow through the fragment partial machinery
        # (streamseg/hcagg are sum-shaped); the scan path carries them
        return None
    if len(col.leaves) == 1 and not col.semis:
        if not allow_single:
            return None
        tr = col.leaves[0]
        frag = FragmentDAG([FragTable(
            tr.table, list(tr.dag.scan.col_offsets),
            list(tr.dag.selection.conditions) if tr.dag.selection else [],
            list(tr.dag.output_types))], [],
            [c for c in col.conds])
        remap = list(range(col.width))
    else:
        asm = _try_assemble(col)
        if asm is None:
            return None
        frag, remap = asm
    frag.agg = DAGAggregation(
        [_remap_expr(g, remap) for g in group_by],
        [AggDesc(d.func,
                 None if d.arg is None else _remap_expr(d.arg, remap),
                 d.ftype, d.distinct, d.name, d.params)
         for d in aggs])
    fields = []
    for i, g in enumerate(group_by):
        fields.append(ResultField(f"gk#{i}", g.ftype))
    for i, d in enumerate(aggs):
        fields.append(ResultField(f"pv#{i}", _partial_val_type(d)))
        fields.append(ResultField(
            f"pc#{i}", FieldType(TypeKind.BIGINT, nullable=False)))
    frag.output_types = [f.ftype for f in fields]
    tr = PhysFragmentRead(frag, PlanSchema(fields))
    return PhysHashAgg("final", plan.group_by, plan.aggs,
                       plan.schema, [tr])


_HC_SCORE_FUNCS = ("sum", "count", "avg")

_FLIP = {"gt": "lt", "lt": "gt", "ge": "le", "le": "ge"}


def _having_entries(conds: list[PlanExpr], agg_node: PhysHashAgg):
    """Extract device-checkable HAVING predicates: comparisons of one
    SUM/COUNT aggregate against a constant, with the threshold converted
    to the aggregate's integer representation. Unconvertible conjuncts
    are simply not pushed — the host Selection re-applies every conjunct
    exactly, so the device filter only needs to be a superset."""
    from ..types.field_type import TypeKind
    from ..types.value import Decimal as Dec

    ngroups = len(agg_node.group_by)
    out = []
    for c in conds:
        if not (isinstance(c, Call) and c.op in _FLIP and
                len(c.args) == 2):
            continue
        a, b = c.args
        op = c.op
        if isinstance(a, Const) and isinstance(b, Col):
            a, b, op = b, a, _FLIP[op]
        if not (isinstance(a, Col) and isinstance(b, Const)):
            continue
        ai = a.idx - ngroups
        if ai < 0 or ai >= len(agg_node.aggs):
            continue
        d = agg_node.aggs[ai]
        if d.func not in ("sum", "count"):
            continue
        # normalize the constant to an exact Decimal (a Const's value is
        # already in ITS OWN ftype's integer representation)
        v = b.value
        try:
            if isinstance(v, Dec):
                dv = v
            elif b.ftype.kind == TypeKind.DECIMAL:
                dv = Dec(int(v), b.ftype.scale)
            elif isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            elif isinstance(v, int):
                dv = Dec(v, 0)
            else:
                dv = Dec.parse(repr(float(v)))
        except (TypeError, ValueError, OverflowError):
            continue
        # the device computes sums in the ARGUMENT's integer
        # representation (the partial layout); the final output type may
        # carry a different (wider) scale
        ft = d.arg.ftype if d.func == "sum" and d.arg is not None \
            else d.ftype
        sc = ft.scale if ft.kind == TypeKind.DECIMAL else 0
        thr = dv.rescale(sc).unscaled
        out.append((ai, op, thr))
    return out


def _resolve_hc_items(sort_node, proj, agg_node) -> Optional[list]:
    """Resolve EVERY sort item to ("group", gi, desc) / ("agg", ai, desc)
    for the fused final cut. Group items may be strings (the executor
    compares dictionary RANKS, order-preserving) but not floats;
    aggregate items must be SUM/COUNT/AVG — sums and counts recombine
    exactly from the candidate limb-pair digits, and AVG compares as the
    exact rational sum/cnt via base-4096 long division on device
    (copr/topnpack.avg_sort_keys; the executor gates it on the
    row-count bound that keeps every division step int32-exact).
    Returns None when any item falls outside that set."""
    ngroups = len(agg_node.group_by)
    out = []
    for e, desc in sort_node.items:
        if proj is not None:
            e = _subst_cols(e, proj.exprs)
        if not isinstance(e, Col):
            return None
        if e.idx < ngroups:
            if agg_node.group_by[e.idx].ftype.is_float:
                return None
            out.append(("group", e.idx, bool(desc)))
        else:
            ai = e.idx - ngroups
            if ai >= len(agg_node.aggs) or \
                    agg_node.aggs[ai].func not in \
                    ("sum", "count", "avg") or \
                    (agg_node.aggs[ai].arg is not None and
                     agg_node.aggs[ai].arg.ftype.is_float):
                return None
            out.append(("agg", ai, bool(desc)))
    return out


def _attach_hc(limit_node, sort_node, proj, agg_node,
               rewritten: PhysHashAgg) -> bool:
    """Resolve the TopN's primary sort item to a device score and attach
    the high-cardinality hint to the fragment under `rewritten`.
    Returns False (no mutation of `rewritten`) when the item cannot score
    on device."""
    frag = rewritten.children[0].frag
    e, desc = sort_node.items[0]
    if proj is not None:
        e = _subst_cols(e, proj.exprs)
    if not isinstance(e, Col):
        return False
    ngroups = len(agg_node.group_by)
    if e.idx < ngroups:
        g = agg_node.group_by[e.idx]
        # dictionary codes are not order-preserving; floats stay host
        if g.ftype.is_string or g.ftype.is_float:
            return False
        score = ("group", e.idx)
    else:
        ai = e.idx - ngroups
        if ai >= len(agg_node.aggs) or \
                agg_node.aggs[ai].func not in _HC_SCORE_FUNCS:
            return False
        score = ("agg", ai)
    frag.hc = HCTopN(score, desc, limit_node.limit)
    # full ORDER BY list resolvable -> the executor may run the fused
    # final cut (join+agg+topn) and return only the k winning groups
    frag.hc.items = _resolve_hc_items(sort_node, proj, agg_node)
    return True


def apply_fragments(plan: PhysicalPlan) -> PhysicalPlan:
    """Top-down, largest-pattern-first rewrite: an aggregation over a join
    tree must be matched at the AGG level before any inner join subtree is
    consumed as a row fragment (bottom-up would fuse the joins alone and
    strand the aggregation on the host). A matched fragment consumes its
    whole subtree; on no match, recurse into children."""
    # TopN over aggregation: Limit(Sort([Proj?](HashAgg))). Matched above
    # the agg so the fragment learns its consumer only needs the top-k
    # groups (high-cardinality candidate path); Sort/Limit stay on the
    # host and re-sort the (few) surviving groups exactly.
    sort_node = None
    if isinstance(plan, PhysLimit) and plan.offset == 0:
        node0 = plan.children[0]
        if isinstance(node0, PhysSort) and node0.items:
            sort_node = node0
        elif isinstance(node0, PhysProjection) and \
                all(isinstance(e, Col) for e in node0.exprs) and \
                isinstance(node0.children[0], PhysSort) and \
                node0.children[0].items:
            # ORDER BY a hidden column: the planner trims it with a
            # plain-Col projection between Limit and Sort — transparent
            # to the TopN patterns below
            sort_node = node0.children[0]
    if sort_node is not None:
        below = sort_node.children[0]
        proj = None
        if isinstance(below, PhysProjection) and \
                all(not _has_subq(x) for x in below.exprs):
            proj = below
            below = below.children[0]
        if isinstance(below, PhysHashAgg) and below.mode == "complete":
            rewritten = _match_agg_fragment(below, allow_single=True)
            if rewritten is not None:
                attached = _attach_hc(plan, sort_node, proj, below,
                                      rewritten)
                single = len(rewritten.children[0].frag.tables) == 1
                if attached or not single:
                    # a join fragment is worthwhile on its own; the
                    # degenerate single-table fragment only serves the hc
                    # hint — keep the original plan if it didn't attach
                    if proj is not None:
                        proj.children = [rewritten]
                    else:
                        sort_node.children = [rewritten]
                    return plan
        if isinstance(below, PhysHashAgg) and below.mode == "final" and \
                len(below.children) == 1 and \
                isinstance(below.children[0], PhysTableRead):
            # single-table agg already pushed into a CopDAG: lift it into a
            # degenerate fragment so the high-cardinality candidate path
            # can serve ORDER BY ... LIMIT k when the dense gate rejects
            tr = below.children[0]
            dag = tr.dag
            if dag.agg is not None and dag.scan.ranges is None and \
                    getattr(tr, "table", None) is not None and \
                    dag.topn is None and dag.limit is None:
                frag = FragmentDAG([FragTable(
                    tr.table, list(dag.scan.col_offsets),
                    list(dag.selection.conditions) if dag.selection else [],
                    _scan_types(tr))], [])
                frag.agg = dag.agg
                frag.output_types = list(dag.output_types)
                frag_tr = PhysFragmentRead(frag, tr.schema)
                old_children = below.children
                below.children = [frag_tr]
                if not _attach_hc(plan, sort_node, proj, below, below):
                    # the degenerate single-table fragment is useful ONLY
                    # with the hc hint — keep the CopDAG pushdown otherwise
                    below.children = old_children
                return plan

        # TopN over a bare join tree (no aggregation): fuse the joins as
        # a row fragment CARRYING the sort+limit, so the device's fused
        # program selects the top-n rows itself (multi-key composite,
        # copr/topnpack.py) and only n rows per batch/shard leave HBM.
        # The host Sort+Limit stay above and merge candidates exactly
        # (a trim projection between them composes into the sort items).
        # Float keys never pack (f32 order breaks exactness) and huge
        # limits would dominate the fetch, so both keep the plain row
        # fragment whose full bitmask the host replays.
        if plan.limit <= 16384:
            items = [( _subst_cols(e, proj.exprs) if proj is not None
                       else e, d) for e, d in sort_node.items]
            if all(expr_pushable(e) and not _has_subq(e)
                   and not e.ftype.is_float for e, _ in items):
                col = _collect_join_tree(below)
                if col is not None and len(col.leaves) > 1:
                    asm = _try_assemble(col)
                    if asm is not None:
                        frag, remap = asm
                        frag.out_map = list(remap)
                        frag.output_types = list(_tree_types(col))
                        frag.topn = DAGTopN(
                            [(_remap_expr(e, remap), bool(d))
                             for e, d in items], plan.limit)
                        tr = PhysFragmentRead(frag, below.schema)
                        if proj is not None:
                            proj.children = [tr]
                        else:
                            sort_node.children = [tr]
                        return plan

    # HAVING over an aggregation: push a safely-widened version of the
    # aggregate-vs-constant predicates into the fragment so the device
    # returns only (a superset of) the passing groups; this Selection
    # stays and re-applies the predicates exactly (reference: HAVING
    # evaluates above the aggregate, planner/core/logical_plan_builder.go
    # buildSelection over LogicalAggregation)
    if isinstance(plan, PhysSelection) and plan.children and \
            isinstance(plan.children[0], PhysHashAgg):
        below = plan.children[0]
        if below.mode == "complete":
            entries = _having_entries(plan.conditions, below)
            if entries:
                rewritten = _match_agg_fragment(below, allow_single=True)
                if rewritten is not None:
                    rewritten.children[0].frag.having = entries
                    plan.children = [rewritten]
                    return plan
        elif below.mode == "final" and len(below.children) == 1 and \
                isinstance(below.children[0], PhysTableRead):
            tr = below.children[0]
            dag = tr.dag
            entries = _having_entries(plan.conditions, below)
            huge = (tr.est_rows or 0) > 2e8
            if entries and not huge and dag.agg is not None and \
                    dag.scan.ranges is None and \
                    getattr(tr, "table", None) is not None and \
                    dag.topn is None and dag.limit is None:
                frag = FragmentDAG([FragTable(
                    tr.table, list(dag.scan.col_offsets),
                    list(dag.selection.conditions) if dag.selection
                    else [], _scan_types(tr))], [])
                frag.agg = dag.agg
                frag.output_types = list(dag.output_types)
                frag.having = entries
                below.children = [PhysFragmentRead(frag, tr.schema)]
                return plan

    if isinstance(plan, PhysHashAgg) and plan.mode == "complete":
        rewritten = _match_agg_fragment(plan)
        if rewritten is not None:
            return rewritten
        plan.children = [apply_fragments(c) for c in plan.children]
        return plan

    if isinstance(plan, (PhysSelection, PhysHashJoin)):
        col = _collect_join_tree(plan)
        if col is not None:
            asm = _try_assemble(col)
            if asm is not None:
                frag, remap = asm
                frag.out_map = list(remap)
                frag.output_types = [
                    leaf_ft for leaf_ft in _tree_types(col)]
                return PhysFragmentRead(frag, plan.schema)
    plan.children = [apply_fragments(c) for c in plan.children]
    return plan


def _tree_types(col: _Collected) -> list[FieldType]:
    out: list[FieldType] = []
    for tr in col.leaves:
        out.extend(tr.dag.output_types)
    return out


def _scan_types(tr: PhysTableRead) -> list[FieldType]:
    """Field types of the scanned columns (local order) from the table
    schema — dag.output_types holds the partial-agg layout when an agg was
    pushed, not the scan columns."""
    by_off = {c.offset: c.ftype for c in tr.table.columns}
    return [by_off[off] for off in tr.dag.scan.col_offsets]
