"""PLONKish circuit IR: columns, selectors, expressions, gates, and the
ConstraintSystem.

Host-side metadata (O(circuit description), never O(rows)) mirroring
halo2_proofs/src/plonk/circuit.rs:
  - Column ordering Instance < Advice < Fixed is consensus-critical
    (circuit.rs:46-104).
  - Expression AST {Constant, Selector, Fixed/Advice/InstanceQuery,
    Negated, Sum, Product, Scaled} with catamorphic evaluate/degree
    (circuit.rs:488-626).
  - ConstraintSystem: deduplicated per-column query lists
    (circuit.rs:1086-1140), degree() (:1401-1431), blinding_factors()
    (:1435-1460), minimum_rows() (:1462-1472).
The gate expressions are evaluated over whole extended-domain tensors by
plonk/evaluation.py.

Copied from halo2_tpu/plonk/circuit.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Callable, Optional

from ..poly.polynomial import Rotation

ADVICE = "advice"
FIXED = "fixed"
INSTANCE = "instance"
_TYPE_ORDER = {INSTANCE: 0, ADVICE: 1, FIXED: 2}


@dataclass(frozen=True, order=False)
class Column:
    index: int
    column_type: str

    def __lt__(self, other: "Column") -> bool:
        # Instance < Advice < Fixed, then by index (circuit.rs:87-104)
        a = (_TYPE_ORDER[self.column_type], self.index)
        b = (_TYPE_ORDER[other.column_type], other.index)
        return a < b

    def sort_key(self):
        return (_TYPE_ORDER[self.column_type], self.index)


@dataclass(frozen=True)
class Selector:
    index: int
    simple: bool

    def expr(self) -> "Expression":
        return SelectorExpr(self)


@dataclass(frozen=True)
class TableColumn:
    """Wraps a fixed column for lookup tables; the inner column is
    deliberately not exposed on the public API (circuit.rs:314-335)."""
    inner: Column


class Expression:
    """Base class for the gate-expression AST."""

    def degree(self) -> int:
        raise NotImplementedError

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        raise NotImplementedError

    # operator lifting (with the simple-selector guards of circuit.rs:722-764)
    def __neg__(self):
        return Negated(self)

    def __add__(self, other):
        other = _lift(other)
        if self.contains_simple_selector() or other.contains_simple_selector():
            raise ValueError("attempted to use a simple selector in addition")
        return Sum(self, other)

    def __radd__(self, other):
        return _lift(other) + self

    def __sub__(self, other):
        other = _lift(other)
        if self.contains_simple_selector() or other.contains_simple_selector():
            raise ValueError(
                "attempted to use a simple selector in subtraction")
        return Sum(self, Negated(other))

    def __rsub__(self, other):
        return _lift(other) - self

    def __mul__(self, other):
        if isinstance(other, int) and not isinstance(other, bool):
            return Scaled(self, other)
        other = _lift(other)
        if self.contains_simple_selector() and other.contains_simple_selector():
            raise ValueError("attempted to multiply two expressions "
                             "containing simple selectors")
        return Product(self, other)

    def __rmul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other)
        return _lift(other) * self

    def contains_simple_selector(self) -> bool:
        return self.evaluate(
            constant=lambda _: False,
            selector_fn=lambda s: s.simple,
            fixed_fn=lambda q: False,
            advice_fn=lambda q: False,
            instance_fn=lambda q: False,
            negated=lambda a: a,
            sum_fn=lambda a, b: a or b,
            product=lambda a, b: a or b,
            scaled=lambda a, _: a,
        )

    def extract_simple_selector(self) -> Optional[Selector]:
        def op(a, b):
            if a is not None and b is not None:
                raise ValueError("two simple selectors cannot be "
                                 "in the same expression")
            return a if a is not None else b
        return self.evaluate(
            constant=lambda _: None,
            selector_fn=lambda s: s if s.simple else None,
            fixed_fn=lambda q: None,
            advice_fn=lambda q: None,
            instance_fn=lambda q: None,
            negated=lambda a: a,
            sum_fn=op, product=op,
            scaled=lambda a, _: a,
        )


def _lift(v) -> Expression:
    if isinstance(v, Expression):
        return v
    if isinstance(v, int):
        return Constant(v)
    raise TypeError(f"cannot lift {type(v)} into Expression")


@dataclass(frozen=True)
class Constant(Expression):
    value: int

    def degree(self):
        return 0

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        return constant(self.value)


@dataclass(frozen=True)
class SelectorExpr(Expression):
    selector: Selector

    def degree(self):
        return 1

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        return selector_fn(self.selector)


@dataclass(frozen=True)
class FixedQuery(Expression):
    query_index: Optional[int]
    column_index: int
    rotation: Rotation

    def degree(self):
        return 1

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        return fixed_fn(self)


@dataclass(frozen=True)
class AdviceQuery(Expression):
    query_index: Optional[int]
    column_index: int
    rotation: Rotation

    def degree(self):
        return 1

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        return advice_fn(self)


@dataclass(frozen=True)
class InstanceQuery(Expression):
    query_index: Optional[int]
    column_index: int
    rotation: Rotation

    def degree(self):
        return 1

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        return instance_fn(self)


@dataclass(frozen=True)
class Negated(Expression):
    expr: Expression

    def degree(self):
        return self.expr.degree()

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        return negated(self.expr.evaluate(
            constant, selector_fn, fixed_fn, advice_fn, instance_fn,
            negated, sum_fn, product, scaled))


@dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        fns = (constant, selector_fn, fixed_fn, advice_fn, instance_fn,
               negated, sum_fn, product, scaled)
        return sum_fn(self.a.evaluate(*fns), self.b.evaluate(*fns))


@dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        fns = (constant, selector_fn, fixed_fn, advice_fn, instance_fn,
               negated, sum_fn, product, scaled)
        return product(self.a.evaluate(*fns), self.b.evaluate(*fns))


@dataclass(frozen=True)
class Scaled(Expression):
    expr: Expression
    scalar: int

    def degree(self):
        return self.expr.degree()

    def evaluate(self, constant, selector_fn, fixed_fn, advice_fn,
                 instance_fn, negated, sum_fn, product, scaled):
        fns = (constant, selector_fn, fixed_fn, advice_fn, instance_fn,
               negated, sum_fn, product, scaled)
        return scaled(self.expr.evaluate(*fns), self.scalar)


@dataclass
class Gate:
    name: str
    constraint_names: list[str]
    polys: list[Expression]
    queried_selectors: list[Selector]
    queried_cells: list[tuple[Column, Rotation]]


@dataclass
class LookupArgument:
    """plonk/lookup.rs:8-76."""
    input_expressions: list[Expression]
    table_expressions: list[Expression]
    name: str = ""

    def required_degree(self) -> int:
        input_degree = max([1] + [e.degree() for e in self.input_expressions])
        table_degree = max([1] + [e.degree() for e in self.table_expressions])
        return max(4, 2 + input_degree + table_degree)


@dataclass
class PermutationArgument:
    """plonk/permutation.rs:12-69."""
    columns: list[Column] = dfield(default_factory=list)

    def required_degree(self) -> int:
        return 3

    def add_column(self, column: Column) -> None:
        if column not in self.columns:
            self.columns.append(column)

    def get_columns(self) -> list[Column]:
        return list(self.columns)


class ConstraintSystem:
    """circuit.rs:996-1472."""

    def __init__(self):
        self.num_fixed_columns = 0
        self.num_advice_columns = 0
        self.num_instance_columns = 0
        self.num_selectors = 0
        self.selector_map: list[Column] = []
        self.gates: list[Gate] = []
        self.advice_queries: list[tuple[Column, Rotation]] = []
        self.num_advice_queries: list[int] = []
        self.instance_queries: list[tuple[Column, Rotation]] = []
        self.fixed_queries: list[tuple[Column, Rotation]] = []
        self.permutation = PermutationArgument()
        self.lookups: list[LookupArgument] = []
        self.constants: list[Column] = []
        self.minimum_degree: Optional[int] = None

    # ---- column constructors ----
    def advice_column(self) -> Column:
        c = Column(self.num_advice_columns, ADVICE)
        self.num_advice_columns += 1
        self.num_advice_queries.append(0)
        return c

    def fixed_column(self) -> Column:
        c = Column(self.num_fixed_columns, FIXED)
        self.num_fixed_columns += 1
        return c

    def instance_column(self) -> Column:
        c = Column(self.num_instance_columns, INSTANCE)
        self.num_instance_columns += 1
        return c

    def selector(self) -> Selector:
        s = Selector(self.num_selectors, simple=True)
        self.num_selectors += 1
        return s

    def complex_selector(self) -> Selector:
        s = Selector(self.num_selectors, simple=False)
        self.num_selectors += 1
        return s

    def lookup_table_column(self) -> TableColumn:
        return TableColumn(inner=self.fixed_column())

    # ---- equality / constants ----
    def enable_equality(self, column: Column) -> None:
        self.query_any_index(column, Rotation(0))
        self.permutation.add_column(column)

    def enable_constant(self, column: Column) -> None:
        if column not in self.constants:
            assert column.column_type == FIXED
            self.constants.append(column)
            self.enable_equality(column)

    # ---- query bookkeeping (circuit.rs:1086-1140) ----
    def query_advice_index(self, column: Column, at: Rotation) -> int:
        for idx, (c, rot) in enumerate(self.advice_queries):
            if c == column and rot == at:
                return idx
        idx = len(self.advice_queries)
        self.advice_queries.append((column, at))
        self.num_advice_queries[column.index] += 1
        return idx

    def query_fixed_index(self, column: Column, at: Rotation) -> int:
        for idx, (c, rot) in enumerate(self.fixed_queries):
            if c == column and rot == at:
                return idx
        idx = len(self.fixed_queries)
        self.fixed_queries.append((column, at))
        return idx

    def query_instance_index(self, column: Column, at: Rotation) -> int:
        for idx, (c, rot) in enumerate(self.instance_queries):
            if c == column and rot == at:
                return idx
        idx = len(self.instance_queries)
        self.instance_queries.append((column, at))
        return idx

    def query_any_index(self, column: Column, at: Rotation) -> int:
        if column.column_type == ADVICE:
            return self.query_advice_index(column, at)
        if column.column_type == FIXED:
            return self.query_fixed_index(column, at)
        return self.query_instance_index(column, at)

    def get_advice_query_index(self, column: Column, at: Rotation) -> int:
        for idx, (c, rot) in enumerate(self.advice_queries):
            if c == column and rot == at:
                return idx
        raise ValueError("query not found")

    def get_fixed_query_index(self, column: Column, at: Rotation) -> int:
        for idx, (c, rot) in enumerate(self.fixed_queries):
            if c == column and rot == at:
                return idx
        raise ValueError("query not found")

    def get_instance_query_index(self, column: Column, at: Rotation) -> int:
        for idx, (c, rot) in enumerate(self.instance_queries):
            if c == column and rot == at:
                return idx
        raise ValueError("query not found")

    def get_any_query_index(self, column: Column, at=Rotation(0)) -> int:
        if column.column_type == ADVICE:
            return self.get_advice_query_index(column, at)
        if column.column_type == FIXED:
            return self.get_fixed_query_index(column, at)
        return self.get_instance_query_index(column, at)

    # ---- gates and lookups ----
    def create_gate(self, name: str,
                    constraints: Callable[["VirtualCells"], list]) -> None:
        cells = VirtualCells(self)
        out = constraints(cells)
        polys = []
        names = []
        for item in out:
            if isinstance(item, tuple):
                cname, expr = item
            else:
                cname, expr = "", item
            names.append(cname)
            polys.append(cells._apply_selectors(expr))
        assert polys, "gates must contain at least one constraint"
        self.gates.append(Gate(
            name=name, constraint_names=names, polys=polys,
            queried_selectors=list(cells.queried_selectors),
            queried_cells=list(cells.queried_cells)))

    def lookup(self, name: str,
               table_map: Callable[["VirtualCells"],
                                   list[tuple[Expression, TableColumn]]]
               ) -> int:
        """Simple-selector-aware lookup registration (circuit.rs lookup():
        input expressions get `selector * expr` applied, and table columns
        become fixed queries at cur)."""
        cells = VirtualCells(self)
        mapping = table_map(cells)
        inputs, tables = [], []
        for input_expr, table in mapping:
            if input_expr.contains_simple_selector():
                raise ValueError(
                    "expression containing simple selector "
                    "supplied to lookup argument")
            table_expr = cells.query_fixed(table.inner, Rotation(0))
            inputs.append(cells._apply_selectors(input_expr))
            tables.append(table_expr)
        index = len(self.lookups)
        self.lookups.append(LookupArgument(
            input_expressions=inputs, table_expressions=tables, name=name))
        return index

    def lookup_any(self, name: str,
                   table_map: Callable[["VirtualCells"],
                                       list[tuple[Expression, Expression]]]
                   ) -> int:
        cells = VirtualCells(self)
        mapping = table_map(cells)
        inputs, tables = [], []
        for input_expr, table_expr in mapping:
            inputs.append(cells._apply_selectors(input_expr))
            tables.append(table_expr)
        index = len(self.lookups)
        self.lookups.append(LookupArgument(
            input_expressions=inputs, table_expressions=tables, name=name))
        return index

    def set_minimum_degree(self, degree: int) -> None:
        self.minimum_degree = degree

    # ---- derived quantities ----
    def degree(self) -> int:
        degree = self.permutation.required_degree()
        degree = max(degree,
                     max([l.required_degree() for l in self.lookups],
                         default=1))
        degree = max(degree,
                     max([p.degree() for g in self.gates for p in g.polys],
                         default=0))
        return max(degree, self.minimum_degree or 1)

    def blinding_factors(self) -> int:
        factors = max(self.num_advice_queries, default=1)
        factors = max(factors, 1)
        factors = max(3, factors)
        factors = factors + 1  # multiopen at x_3
        return factors + 1     # off-by-one defense

    def minimum_rows(self) -> int:
        return self.blinding_factors() + 3


class VirtualCells:
    """Query builder handed to create_gate/lookup closures
    (circuit.rs:1477-1547)."""

    def __init__(self, meta: ConstraintSystem):
        self.meta = meta
        self.queried_selectors: list[Selector] = []
        self.queried_cells: list[tuple[Column, Rotation]] = []

    def query_selector(self, selector: Selector) -> Expression:
        self.queried_selectors.append(selector)
        return SelectorExpr(selector)

    def query_fixed(self, column: Column, at: Rotation = Rotation(0)
                    ) -> Expression:
        self.queried_cells.append((column, at))
        return FixedQuery(
            query_index=self.meta.query_fixed_index(column, at),
            column_index=column.index, rotation=at)

    def query_advice(self, column: Column, at: Rotation = Rotation(0)
                     ) -> Expression:
        self.queried_cells.append((column, at))
        return AdviceQuery(
            query_index=self.meta.query_advice_index(column, at),
            column_index=column.index, rotation=at)

    def query_instance(self, column: Column, at: Rotation = Rotation(0)
                       ) -> Expression:
        self.queried_cells.append((column, at))
        return InstanceQuery(
            query_index=self.meta.query_instance_index(column, at),
            column_index=column.index, rotation=at)

    def query_any(self, column: Column, at: Rotation = Rotation(0)
                  ) -> Expression:
        if column.column_type == ADVICE:
            return self.query_advice(column, at)
        if column.column_type == FIXED:
            return self.query_fixed(column, at)
        return self.query_instance(column, at)

    def _apply_selectors(self, expr: Expression) -> Expression:
        """No-op pass-through: selectors stay symbolic until
        compress_selectors replaces them at keygen (plonk/circuit.rs
        Constraints handling keeps Selector leaves in the AST)."""
        return expr
