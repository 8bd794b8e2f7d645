"""Inject/withdraw rate constraints ("ratchets").

Host-side (numpy, float64) implementations of the constraint family of the
reference (``InjectWithdrawConstraints/*.cs``): given inventory, return the
feasible (min, max) inject/withdraw rate, and solve the *inverse* problem used
by the inventory-space reduction — given the next period's feasible inventory
band, the highest/lowest current inventory from which that band is reachable.

These objects only run during facility compilation.  For device code every
constraint is lowered to a piecewise table (see ``facility.CompiledFacility``),
so the valuation kernels contain no Python constraint objects.

Sign convention (as in the reference): negative rates are withdrawals,
positive rates injections.
"""
from __future__ import annotations

import typing as tp

import numpy as np


class InventoryConstraintsCannotBeFulfilledException(ValueError):
    """Feasible inventory band is empty, or an inventory-space inverse problem
    has no solution (reference
    ``InventoryConstraintsCannotBeFulfilledException.cs:31``; thrown from both
    the band reduction and the constraint-level solvers,
    ``StorageHelper.cs:101-102``).  Subclasses ``ValueError`` so callers
    catching the generic type keep working."""


class InjectWithdrawRange(tp.NamedTuple):
    min_inject_withdraw_rate: float
    max_inject_withdraw_rate: float


class RatchetNode(tp.NamedTuple):
    inventory: float
    min_rate: float
    max_rate: float


def _interp_linear_and_solve(x1, y1, x2, y2, y):
    """Solve x for known y on the line through (x1,y1),(x2,y2)
    (reference ``StorageHelper.InterpolateLinearAndSolve``, StorageHelper.cs:321-330)."""
    gradient = (y2 - y1) / (x2 - x1)
    constant = y1 - gradient * x1
    return (y - constant) / gradient


class BaseConstraint:
    """Interface mirroring ``IInjectWithdrawConstraint`` (IInjectWithdrawConstraint.cs:28-35)."""

    def get_inject_withdraw_range(self, inventory: float) -> InjectWithdrawRange:
        raise NotImplementedError

    def inventory_space_upper_bound(
        self,
        next_lower: float,
        next_upper: float,
        min_inventory: float,
        max_inventory: float,
        inventory_pcnt_loss: float,
    ) -> float:
        raise NotImplementedError

    def inventory_space_lower_bound(
        self,
        next_lower: float,
        next_upper: float,
        min_inventory: float,
        max_inventory: float,
        inventory_pcnt_loss: float,
    ) -> float:
        raise NotImplementedError

    def table(self, min_inventory: float, max_inventory: float, step_interp_as_linear_nodes: bool = False
              ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
        """Lower the constraint to (inventories, min_rates, max_rates, is_step)
        for device-side vectorised lookup.  ``step_interp_as_linear_nodes``
        asks STEP constraints to lower as staircase linear nodes (used when a
        facility mixes step and continuous interpolation across periods);
        continuous constraints ignore it."""
        raise NotImplementedError


class ConstantInjectWithdrawConstraint(BaseConstraint):
    """Inventory-independent rates (``ConstantInjectWithdrawConstraint.cs:31``)."""

    def __init__(self, min_rate: float, max_rate: float):
        if min_rate > max_rate:
            raise ValueError("min rate cannot exceed max rate.")
        self.min_rate = float(min_rate)
        self.max_rate = float(max_rate)

    def get_inject_withdraw_range(self, inventory: float) -> InjectWithdrawRange:
        return InjectWithdrawRange(self.min_rate, self.max_rate)

    def inventory_space_upper_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        # Highest current inventory from which, after loss and max withdrawal,
        # next_upper is still reachable (cannot end above next_upper).
        upper = (next_upper - self.min_rate) / (1.0 - inventory_pcnt_loss)
        return min(upper, max_inventory)

    def inventory_space_lower_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        lower = (next_lower - self.max_rate) / (1.0 - inventory_pcnt_loss)
        return max(lower, min_inventory)

    def table(self, min_inventory, max_inventory, step_interp_as_linear_nodes=False):
        inv = np.array([min_inventory, max_inventory], dtype=np.float64)
        return (
            inv,
            np.full(2, self.min_rate, dtype=np.float64),
            np.full(2, self.max_rate, dtype=np.float64),
            False,
        )


class PiecewiseLinearInjectWithdrawConstraint(BaseConstraint):
    """Rates linearly interpolated between inventory nodes
    (``PiecewiseLinearInjectWithdrawConstraint.cs:34-161``)."""

    def __init__(self, nodes: tp.Iterable[tp.Tuple[float, float, float]]):
        sorted_nodes = sorted((RatchetNode(*n) for n in nodes), key=lambda n: n.inventory)
        if len(sorted_nodes) < 2:
            raise ValueError(
                "Inject/withdraw ranges collection must contain at least two elements."
            )
        self.nodes = sorted_nodes
        self.inventories = np.array([n.inventory for n in sorted_nodes], dtype=np.float64)
        self.min_rates = np.array([n.min_rate for n in sorted_nodes], dtype=np.float64)
        self.max_rates = np.array([n.max_rate for n in sorted_nodes], dtype=np.float64)
        if np.any(self.min_rates > self.max_rates):
            raise ValueError("Ratchet min rate cannot exceed max rate.")

    def get_inject_withdraw_range(self, inventory: float) -> InjectWithdrawRange:
        min_rate = float(np.interp(inventory, self.inventories, self.min_rates))
        max_rate = float(np.interp(inventory, self.inventories, self.max_rates))
        return InjectWithdrawRange(min_rate, max_rate)

    def inventory_space_upper_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        # Mirrors the bracket scan of PiecewiseLinearInjectWithdrawConstraint.cs:74-116.
        rng_at_max = self.get_inject_withdraw_range(max_inventory)
        next_max_from_max = max_inventory * (1 - inventory_pcnt_loss) + rng_at_max.max_inject_withdraw_rate
        next_min_from_max = max_inventory * (1 - inventory_pcnt_loss) + rng_at_max.min_inject_withdraw_rate
        if next_min_from_max <= next_upper and next_lower <= next_max_from_max:
            return max_inventory

        bracket_upper_inv = self.inventories[-1]
        bracket_upper_after = next_min_from_max
        for i in range(len(self.nodes) - 2, -1, -1):
            lower = self.nodes[i]
            lower_after = lower.inventory * (1 - inventory_pcnt_loss) + lower.min_rate
            if lower_after <= next_upper <= bracket_upper_after:
                return _interp_linear_and_solve(
                    lower.inventory, lower_after, bracket_upper_inv, bracket_upper_after, next_upper
                )
            bracket_upper_after = lower_after
            bracket_upper_inv = lower.inventory
        raise InventoryConstraintsCannotBeFulfilledException(
            "Storage inventory constraints cannot be satisfied."
        )

    def inventory_space_lower_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        # Mirrors PiecewiseLinearInjectWithdrawConstraint.cs:118-160.
        rng_at_min = self.get_inject_withdraw_range(min_inventory)
        next_max_from_min = min_inventory * (1 - inventory_pcnt_loss) + rng_at_min.max_inject_withdraw_rate
        next_min_from_min = min_inventory * (1 - inventory_pcnt_loss) + rng_at_min.min_inject_withdraw_rate
        if next_min_from_min <= next_upper and next_lower <= next_max_from_min:
            return min_inventory

        bracket_lower_inv = self.inventories[0]
        bracket_lower_after = next_max_from_min
        for i in range(1, len(self.nodes)):
            upper = self.nodes[i]
            upper_after = upper.inventory * (1 - inventory_pcnt_loss) + upper.max_rate
            if bracket_lower_after <= next_lower <= upper_after:
                return _interp_linear_and_solve(
                    bracket_lower_inv, bracket_lower_after, upper.inventory, upper_after, next_lower
                )
            bracket_lower_after = upper_after
            bracket_lower_inv = upper.inventory
        raise InventoryConstraintsCannotBeFulfilledException(
            "Storage inventory constraints cannot be satisfied."
        )

    def table(self, min_inventory, max_inventory, step_interp_as_linear_nodes=False):
        return self.inventories, self.min_rates, self.max_rates, False


class StepInjectWithdrawConstraint(BaseConstraint):
    """Piecewise-constant (left-continuous step) rates
    (``StepInjectWithdrawConstraint.cs:33-167``).

    Rates between node i and node i+1 equal the rates at node i; the top two
    nodes must have equal rates, and rates must be monotone non-increasing in
    inventory (injection) / non-decreasing magnitude (withdrawal), as validated
    by the reference constructor.
    """

    _TOL = 1e-12

    def __init__(self, nodes: tp.Iterable[tp.Tuple[float, float, float]]):
        sorted_nodes = sorted((RatchetNode(*n) for n in nodes), key=lambda n: n.inventory)
        if len(sorted_nodes) < 2:
            raise ValueError(
                "Inject/withdraw ranges collection must contain at least two elements."
            )
        second_top, top = sorted_nodes[-2], sorted_nodes[-1]
        if abs(second_top.max_rate - top.max_rate) > self._TOL:
            raise ValueError("Top two ratchets do not have the same max injection rate.")
        if abs(second_top.min_rate - top.min_rate) > self._TOL:
            raise ValueError("Top two ratchets do not have the same max withdrawal rate.")
        for i in range(1, len(sorted_nodes) - 1):
            if sorted_nodes[i].max_rate > sorted_nodes[i - 1].max_rate:
                raise ValueError("Ratchet injection rates cannot increase with inventory.")
            if sorted_nodes[i].min_rate > sorted_nodes[i - 1].min_rate:
                raise ValueError("Ratchet withdrawal rates cannot decrease with inventory.")
        self.nodes = sorted_nodes
        self.inventories = np.array([n.inventory for n in sorted_nodes], dtype=np.float64)
        self.min_rates = np.array([n.min_rate for n in sorted_nodes], dtype=np.float64)
        self.max_rates = np.array([n.max_rate for n in sorted_nodes], dtype=np.float64)

    def get_inject_withdraw_range(self, inventory: float) -> InjectWithdrawRange:
        if inventory < self.inventories[0] or inventory > self.inventories[-1]:
            raise ValueError(
                f"Value of inventory is outside of the interval "
                f"[{self.inventories[0]}, {self.inventories[-1]}]."
            )
        idx = int(np.searchsorted(self.inventories, inventory, side="right")) - 1
        idx = min(idx, len(self.nodes) - 1)
        return InjectWithdrawRange(float(self.min_rates[idx]), float(self.max_rates[idx]))

    def inventory_space_upper_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        rng_at_max = self.get_inject_withdraw_range(max_inventory)
        next_max_from_max = max_inventory * (1 - inventory_pcnt_loss) + rng_at_max.max_inject_withdraw_rate
        next_min_from_max = max_inventory * (1 - inventory_pcnt_loss) + rng_at_max.min_inject_withdraw_rate
        if next_min_from_max <= next_upper and next_lower <= next_max_from_max:
            return max_inventory
        # Keep the maximum solution across brackets (StepInjectWithdrawConstraint.cs:99-122).
        solution = None
        for i in range(len(self.nodes) - 1):
            max_withdraw = self.nodes[i].min_rate
            lo_inv, hi_inv = self.nodes[i].inventory, self.nodes[i + 1].inventory
            lo_after = lo_inv * (1 - inventory_pcnt_loss) + max_withdraw
            hi_after = hi_inv * (1 - inventory_pcnt_loss) + max_withdraw
            if lo_after <= next_upper <= hi_after:
                solution = _interp_linear_and_solve(lo_inv, lo_after, hi_inv, hi_after, next_upper)
        if solution is None:
            raise InventoryConstraintsCannotBeFulfilledException(
                "Storage inventory constraints cannot be satisfied."
            )
        return solution

    def inventory_space_lower_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        rng_at_min = self.get_inject_withdraw_range(min_inventory)
        next_max_from_min = min_inventory * (1 - inventory_pcnt_loss) + rng_at_min.max_inject_withdraw_rate
        next_min_from_min = min_inventory * (1 - inventory_pcnt_loss) + rng_at_min.min_inject_withdraw_rate
        if next_min_from_min <= next_upper and next_lower <= next_max_from_min:
            return min_inventory
        # Keep the minimum solution across brackets (StepInjectWithdrawConstraint.cs:143-165).
        solution = None
        for i in range(len(self.nodes) - 2, -1, -1):
            max_inject = self.nodes[i].max_rate
            lo_inv, hi_inv = self.nodes[i].inventory, self.nodes[i + 1].inventory
            lo_after = lo_inv * (1 - inventory_pcnt_loss) + max_inject
            hi_after = hi_inv * (1 - inventory_pcnt_loss) + max_inject
            if lo_after <= next_lower <= hi_after:
                solution = _interp_linear_and_solve(lo_inv, lo_after, hi_inv, hi_after, next_lower)
        if solution is None:
            raise InventoryConstraintsCannotBeFulfilledException(
                "Storage inventory constraints cannot be satisfied."
            )
        return solution

    def table(self, min_inventory, max_inventory, step_interp_as_linear_nodes=False):
        if not step_interp_as_linear_nodes:
            return self.inventories, self.min_rates, self.max_rates, True
        # Staircase lowering for facilities that MIX step and continuous
        # ratchet interpolation across periods (the reference permits
        # per-period constraint objects of any type, CmdtyStorage.cs:41-50):
        # each step node x_r becomes the linear-node pair
        # (x_r − δ, v_{r-1}), (x_r, v_r) with δ one part in 2^22 of the node
        # scale — wide enough to survive the engines' f32 tables, narrow
        # enough that the blended window is far inside any physical rate
        # resolution.  Off the δ-windows the lerp reproduces the step
        # function exactly.
        inv, mn, mx = [self.inventories[0]], [self.min_rates[0]], [self.max_rates[0]]
        for r in range(1, len(self.inventories)):
            x_r = self.inventories[r]
            delta = max(abs(x_r), abs(self.inventories[-1] - self.inventories[0]), 1.0) * 2.0**-22
            lo = x_r - delta
            if lo > inv[-1]:
                inv.append(lo)
                mn.append(self.min_rates[r - 1])
                mx.append(self.max_rates[r - 1])
            inv.append(x_r)
            mn.append(self.min_rates[r])
            mx.append(self.max_rates[r])
        return (
            np.asarray(inv, dtype=np.float64),
            np.asarray(mn, dtype=np.float64),
            np.asarray(mx, dtype=np.float64),
            False,
        )


class PolynomialInjectWithdrawConstraint(BaseConstraint):
    """Rates given by the exact polynomial through the supplied inventory nodes
    (``PolynomialInjectWithdrawConstraint.cs:35-157``).

    The inverse problems are solved with numpy polynomial root finding instead
    of robust Newton-Raphson; for device lookup the polynomial is sampled onto
    a piecewise-linear table whose density is chosen ADAPTIVELY: enough points
    that the linear-interpolation error is below float32 resolution of the
    rate scale (making the table the exact polynomial to device precision —
    the engines run f32) whenever that fits a 129-node budget, else the
    tightest 129-node table.  The realised
    error bound is computable via ``table_error_bound`` (measured-vs-bound
    pinned in tests/test_polynomial_ratchets.py); ``num_table_points``
    overrides the adaptive choice when set (larger tables are fine on the
    XLA paths).
    """

    # f32-exactness target for the lerp error, relative to the rate scale.
    _REL_TOL = 2.0**-24
    # The forward pass looks each path's rates up in the table every step
    # (O(nodes) per path): the budget bounds that work.
    _MAX_TABLE_POINTS = 129

    def __init__(self, nodes: tp.Iterable[tp.Tuple[float, float, float]], num_table_points: tp.Optional[int] = None):
        sorted_nodes = sorted((RatchetNode(*n) for n in nodes), key=lambda n: n.inventory)
        if len(sorted_nodes) < 2:
            raise ValueError(
                "Inject/withdraw ranges collection must contain at least two elements."
            )
        self.nodes = sorted_nodes
        self.inventories = np.array([n.inventory for n in sorted_nodes], dtype=np.float64)
        min_rates = np.array([n.min_rate for n in sorted_nodes], dtype=np.float64)
        max_rates = np.array([n.max_rate for n in sorted_nodes], dtype=np.float64)
        degree = len(sorted_nodes) - 1
        self._min_poly = np.polynomial.Polynomial.fit(self.inventories, min_rates, degree).convert()
        self._max_poly = np.polynomial.Polynomial.fit(self.inventories, max_rates, degree).convert()
        self._num_table_points = num_table_points

    def get_inject_withdraw_range(self, inventory: float) -> InjectWithdrawRange:
        return InjectWithdrawRange(
            float(self._min_poly(inventory)), float(self._max_poly(inventory))
        )

    def _solve(self, poly_after_decision_minus_target, lo, hi, pick_max: bool):
        roots = poly_after_decision_minus_target.roots()
        real = roots[np.isclose(roots.imag, 0.0, atol=1e-9)].real
        eps = 1e-9 * max(1.0, abs(hi - lo))
        candidates = real[(real >= lo - eps) & (real <= hi + eps)]
        if len(candidates) == 0:
            raise InventoryConstraintsCannotBeFulfilledException(
                "Storage inventory constraints cannot be satisfied."
            )
        return float(np.max(candidates) if pick_max else np.min(candidates))

    def inventory_space_upper_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        rng_at_max = self.get_inject_withdraw_range(max_inventory)
        next_max_from_max = max_inventory * (1 - inventory_pcnt_loss) + rng_at_max.max_inject_withdraw_rate
        next_min_from_max = max_inventory * (1 - inventory_pcnt_loss) + rng_at_max.min_inject_withdraw_rate
        if next_min_from_max <= next_upper and next_lower <= next_max_from_max:
            return max_inventory
        ident = np.polynomial.Polynomial([0.0, 1.0 - inventory_pcnt_loss])
        target_poly = ident + self._min_poly - next_upper
        return self._solve(target_poly, min_inventory, max_inventory, pick_max=True)

    def inventory_space_lower_bound(
        self, next_lower, next_upper, min_inventory, max_inventory, inventory_pcnt_loss
    ) -> float:
        rng_at_min = self.get_inject_withdraw_range(min_inventory)
        next_max_from_min = min_inventory * (1 - inventory_pcnt_loss) + rng_at_min.max_inject_withdraw_rate
        next_min_from_min = min_inventory * (1 - inventory_pcnt_loss) + rng_at_min.min_inject_withdraw_rate
        if next_min_from_min <= next_upper and next_lower <= next_max_from_min:
            return min_inventory
        ident = np.polynomial.Polynomial([0.0, 1.0 - inventory_pcnt_loss])
        target_poly = ident + self._max_poly - next_lower
        return self._solve(target_poly, min_inventory, max_inventory, pick_max=False)

    def _adaptive_points(self, lo: float, hi: float) -> int:
        """Sample count making the piecewise-linear error ≤ _REL_TOL of the
        rate scale: for segment width h the lerp error of a C² function is
        bounded by max|p''|·h²/8, so h ≤ √(8·tol/max|p''|)."""
        span = float(hi - lo)
        if span <= 0:
            return 2
        probe = np.linspace(lo, hi, 257)
        scale = max(
            1.0,
            float(np.max(np.abs(self._min_poly(probe)))),
            float(np.max(np.abs(self._max_poly(probe)))),
        )
        curv = max(
            float(np.max(np.abs(self._min_poly.deriv(2)(probe)))),
            float(np.max(np.abs(self._max_poly.deriv(2)(probe)))),
        )
        tol = self._REL_TOL * scale
        if curv <= 0:
            return 2  # affine: two nodes are exact
        h = np.sqrt(8.0 * tol / curv)
        n = int(np.ceil(span / h)) + 1
        return int(np.clip(n, 2, self._MAX_TABLE_POINTS))

    def table_error_bound(self, min_inventory, max_inventory) -> float:
        """Bound on |table lerp − exact polynomial| over the sampled range
        (asserted against measured error in tests/test_polynomial_ratchets.py)."""
        n = self._table_points(min_inventory, max_inventory)
        span = float(max_inventory - min_inventory)
        if span <= 0 or n < 2:
            return 0.0
        h = span / (n - 1)
        probe = np.linspace(min_inventory, max_inventory, 257)
        curv = max(
            float(np.max(np.abs(self._min_poly.deriv(2)(probe)))),
            float(np.max(np.abs(self._max_poly.deriv(2)(probe)))),
        )
        return curv * h * h / 8.0

    def _table_points(self, lo, hi) -> int:
        if self._num_table_points is not None:
            return int(self._num_table_points)
        return self._adaptive_points(float(lo), float(hi))

    def table(self, min_inventory, max_inventory, step_interp_as_linear_nodes=False):
        inv = np.linspace(
            min_inventory, max_inventory,
            self._table_points(min_inventory, max_inventory),
        )
        return (
            inv,
            self._min_poly(inv).astype(np.float64),
            self._max_poly(inv).astype(np.float64),
            False,
        )


class InjectWithdrawRangeByInventory(tp.NamedTuple):
    """An (inventory, range) ratchet node (InjectWithdrawRangeByInventory.cs:31)."""

    inventory: float
    inject_withdraw_range: InjectWithdrawRange


class InjectWithdrawRangeByInventoryAndPeriod(tp.NamedTuple):
    """A dated set of ratchet nodes (InjectWithdrawRangeByInventoryAndPeriod.cs:34)."""

    period: object
    inject_withdraw_ranges: tp.Tuple[InjectWithdrawRangeByInventory, ...]
