"""Basis functions for the LSMC regression.

The reference exposes a string mini-DSL like ``"1 + x_st + s*x0**2"`` that it
compiles to C# delegates with Roslyn (``BasisFunctionsBuilder.cs:90-129``).
Here the same grammar is parsed into plain monomial descriptors
``(spot_power, {factor_index: power})`` — no code generation — and the design
matrix is evaluated as a vectorised jnp expression (integer powers by repeated
multiplication so everything fuses into one elementwise kernel).
"""
from __future__ import annotations

import re
import typing as tp

import jax.numpy as jnp


class Monomial(tp.NamedTuple):
    spot_power: int
    factor_powers: tp.Tuple[tp.Tuple[int, int], ...]  # ((factor_index, power), ...)

    def __str__(self) -> str:
        parts = []
        if self.spot_power:
            parts.append("s" if self.spot_power == 1 else f"s**{self.spot_power}")
        for idx, p in self.factor_powers:
            parts.append(f"x{idx}" if p == 1 else f"x{idx}**{p}")
        return " * ".join(parts) if parts else "1"


class GenericBasisFunction:
    """A user-supplied basis function (reference ``BasisFunction.cs:30`` /
    ``BasisFunctions.Generic``, ``BasisFunctions.cs:92``): any callable
    ``fn(spot, factors) -> column`` writing one design-matrix column, where
    ``spot`` is the [S] simulated spot vector for one period and ``factors``
    the [F, S] simulated Markov factors.  The callable must be jnp-traceable
    (it runs under jit); it may return shape [S] or anything broadcastable
    to it (e.g. a scalar for a constant column).

    ``num_factors`` declares how many factors the callable reads (validated
    against the simulated factor count like monomial factor indices are);
    ``label`` names the function in reprs/errors.

    Generic entries compare (and hash) by identity, so repeated-monomial
    validation and jit static-arg caching behave naturally.  Valuations
    containing a generic basis function keep the backward decision update
    on the XLA body (api_lsmc logs the choice).
    """

    __slots__ = ("fn", "num_factors", "label")

    def __init__(self, fn: tp.Callable, num_factors: int = 0,
                 label: tp.Optional[str] = None):
        if not callable(fn):
            raise TypeError("GenericBasisFunction requires a callable.")
        if num_factors < 0:
            raise ValueError("num_factors must be non-negative.")
        self.fn = fn
        self.num_factors = int(num_factors)
        self.label = label or getattr(fn, "__name__", "generic")

    def __call__(self, spot, factors):
        return self.fn(spot, factors)

    def __repr__(self) -> str:
        return f"GenericBasisFunction({self.label})"

    def __str__(self) -> str:
        return self.label

    def __add__(self, other) -> "BasisFunctionList":
        return BasisFunctionList([self]) + other

    def __radd__(self, other) -> "BasisFunctionList":
        return _as_monomial_list(other) + BasisFunctionList([self])


def generic(fn: tp.Callable, num_factors: int = 0,
            label: tp.Optional[str] = None) -> GenericBasisFunction:
    """Wrap a callable as a basis function (BasisFunctions.Generic analog)."""
    return GenericBasisFunction(fn, num_factors, label)


def has_generic(basis_entries: tp.Sequence) -> bool:
    """True when any basis entry is a user callable (forces the XLA path)."""
    return any(isinstance(m, GenericBasisFunction) for m in basis_entries)


_TOKEN_RE = re.compile(r"^(?:(?P<one>1)|(?P<spot>[sS])|x(?P<factor>\d+))(?:\*\*(?P<power>\d+))?$")

# Factor aliases used by three_factor_seasonal_value (multi_factor.py:125-126).
_FACTOR_ALIASES = {"x_st": "x0", "x_lt": "x1", "x_sw": "x2"}


def parse_basis_functions(expression: str) -> tp.List[Monomial]:
    """Parse the basis-function DSL into monomials.

    Grammar (BasisFunctionsBuilder.cs:90-129): monomials separated by ``+``;
    each monomial is a ``*``-product of ``1``, ``s``/``S`` (spot) and ``xN``
    (Markov factor N), each optionally raised with ``**p``.  Repeated monomial
    strings raise, as in the reference.
    """
    if expression is None:
        raise ValueError("Basis function expression cannot be None.")
    for alias, canonical in _FACTOR_ALIASES.items():
        expression = expression.replace(alias, canonical)
    monomial_strs = [m.strip() for m in expression.split("+")]
    if any(not m for m in monomial_strs):
        raise ValueError("Basis function expression contains an empty monomial.")
    if len(set(monomial_strs)) < len(monomial_strs):
        raise ValueError("Basis function expression contains repeated monomials.")
    return [_parse_monomial(m) for m in monomial_strs]


def _parse_monomial(monomial: str) -> Monomial:
    spot_power = 0
    factor_powers: tp.Dict[int, int] = {}
    for token in (t.strip() for t in _split_product(monomial)):
        match = _TOKEN_RE.match(token)
        if not match:
            raise ValueError(f"Cannot parse basis function term '{token}' in '{monomial}'.")
        power = int(match.group("power")) if match.group("power") else 1
        if match.group("one"):
            continue
        if match.group("spot"):
            spot_power += power
        else:
            idx = int(match.group("factor"))
            factor_powers[idx] = factor_powers.get(idx, 0) + power
    return Monomial(spot_power, tuple(sorted(factor_powers.items())))


def _split_product(monomial: str) -> tp.List[str]:
    """Split on single ``*`` but not ``**``."""
    parts: tp.List[str] = []
    current = []
    i = 0
    while i < len(monomial):
        ch = monomial[i]
        if ch == "*":
            if i + 1 < len(monomial) and monomial[i + 1] == "*":
                current.append("**")
                i += 2
                continue
            parts.append("".join(current))
            current = []
            i += 1
            continue
        current.append(ch)
        i += 1
    parts.append("".join(current))
    return parts


def num_factors_required(monomials: tp.Sequence) -> int:
    highest = -1
    for m in monomials:
        if isinstance(m, GenericBasisFunction):
            highest = max(highest, m.num_factors - 1)
            continue
        for idx, _ in m.factor_powers:
            highest = max(highest, idx)
    return highest + 1


def _ipow(x, p: int):
    """x**p for small static integer p via repeated multiplication."""
    if p == 0:
        return jnp.ones_like(x)
    result = x
    for _ in range(p - 1):
        result = result * x
    return result


def design_matrix(monomials: tp.Sequence[Monomial], spot, factors):
    """Evaluate the design matrix.

    ``spot``: [S] simulated spot prices for one period; ``factors``: [F, S]
    simulated Markov factors.  Returns X with shape [S, B]
    (analog of ``LsmcStorageValuation.PopulateDesignMatrix``,
    LsmcStorageValuation.cs:838-855).
    """
    cols = []
    for m in monomials:
        if isinstance(m, GenericBasisFunction):
            cols.append(jnp.broadcast_to(jnp.asarray(m(spot, factors), spot.dtype),
                                         spot.shape))
            continue
        col = jnp.ones_like(spot)
        if m.spot_power:
            col = col * _ipow(spot, m.spot_power)
        for idx, p in m.factor_powers:
            col = col * _ipow(factors[idx], p)
        cols.append(col)
    return jnp.stack(cols, axis=-1)


# --------------------------------------------------------------- combinators
#
# Pythonic analog of the reference's operator-overloaded basis-function
# combinators (BasisFunctions/Sim.cs:30-40, PowerMonomialBuilder.cs:44-59,
# BasisFunctions.cs:34-92): build monomials with `*` / `**` on the `S` (spot)
# and `X0..X9` (Markov factor) atoms, sum them with `+`:
#
#     basis = ONE + S + S**2 + X0 + X0**2 + S * X1
#
# The result is a BasisFunctionList of the same Monomial descriptors the
# string DSL produces, accepted anywhere a `basis_funcs` string is.


class BasisFunctionList(list):
    """A `+`-composable list of Monomials."""

    def __add__(self, other):
        return BasisFunctionList(list(self) + list(_as_monomial_list(other)))

    def __radd__(self, other):
        return BasisFunctionList(list(_as_monomial_list(other)) + list(self))


class MonomialBuilder:
    """One monomial under construction: supports ``*``, ``**`` and ``+``."""

    __array_priority__ = 1000  # keep numpy from hijacking the operators

    def __init__(self, monomial: Monomial):
        self.monomial = monomial

    def __pow__(self, power: int) -> "MonomialBuilder":
        if not isinstance(power, int) or power < 0:
            raise ValueError("Basis-function powers must be non-negative integers.")
        merged: tp.Dict[int, int] = {}
        for idx, p in self.monomial.factor_powers:
            merged[idx] = p * power
        return MonomialBuilder(
            Monomial(self.monomial.spot_power * power, tuple(sorted(merged.items())))
        )

    def __mul__(self, other) -> "MonomialBuilder":
        if isinstance(other, MonomialBuilder):
            merged = dict(self.monomial.factor_powers)
            for idx, p in other.monomial.factor_powers:
                merged[idx] = merged.get(idx, 0) + p
            return MonomialBuilder(
                Monomial(
                    self.monomial.spot_power + other.monomial.spot_power,
                    tuple(sorted(merged.items())),
                )
            )
        if other == 1:
            return self
        return NotImplemented

    __rmul__ = __mul__

    def __add__(self, other) -> BasisFunctionList:
        return BasisFunctionList([self.monomial]) + other

    def __radd__(self, other) -> BasisFunctionList:
        return _as_monomial_list(other) + BasisFunctionList([self.monomial])

    def __repr__(self) -> str:
        return f"MonomialBuilder({self.monomial})"


def _as_monomial_list(value) -> BasisFunctionList:
    if isinstance(value, BasisFunctionList):
        return value
    if isinstance(value, MonomialBuilder):
        return BasisFunctionList([value.monomial])
    if isinstance(value, (Monomial, GenericBasisFunction)):
        return BasisFunctionList([value])
    if isinstance(value, (list, tuple)):
        # Coerce element-wise so builder atoms (ONE, S, X0**2), generics,
        # bare callables, raw Monomials, and the literal 1 all mix freely in
        # one list — the same terms `+`-sums accept.
        out = BasisFunctionList()
        for m in value:
            out = out + _as_monomial_list(m)
        return out
    if callable(value):  # bare callables wrap as generic basis functions
        return BasisFunctionList([GenericBasisFunction(value)])
    if value == 1:  # the constant term: `1 + S + ...`
        return BasisFunctionList([Monomial(0, ())])
    raise TypeError(f"Cannot use {value!r} as a basis function term.")


ONE = MonomialBuilder(Monomial(0, ()))  # BasisFunctions.Ones (BasisFunctions.cs:34)
S = MonomialBuilder(Monomial(1, ()))  # Sim.Spot / Sim.S (Sim.cs:30-31)


def X(factor_index: int) -> MonomialBuilder:
    """Markov factor atom (Sim.X0..X9, Sim.cs:32-40)."""
    if factor_index < 0:
        raise ValueError("Factor index must be non-negative.")
    return MonomialBuilder(Monomial(0, ((factor_index, 1),)))


X0, X1, X2, X3, X4, X5, X6, X7, X8, X9 = (X(i) for i in range(10))
# 3-factor-seasonal aliases (multi_factor.py:125-126): short-term / long-term / seasonal.
X_ST, X_LT, X_SW = X0, X1, X2


def spot_price_power(power: int) -> MonomialBuilder:
    """BasisFunctions.SpotPricePower (BasisFunctions.cs:48)."""
    return S ** power


def markov_factor_power(factor_index: int, power: int) -> MonomialBuilder:
    """BasisFunctions.MarkovFactorPower (BasisFunctions.cs:59)."""
    return X(factor_index) ** power


def coerce_basis_functions(value) -> tp.List[Monomial]:
    """Accept the string DSL, a combinator expression (`ONE + S + X0**2`), a
    single atom, a user callable / GenericBasisFunction (mixable with
    monomials in a list or `+`-sum), or a pre-built Monomial list; returns
    the basis-entry list."""
    if isinstance(value, str):
        return parse_basis_functions(value)
    monomials = list(_as_monomial_list(value))
    if len(set(monomials)) < len(monomials):
        raise ValueError("Basis function expression contains repeated monomials.")
    return monomials
