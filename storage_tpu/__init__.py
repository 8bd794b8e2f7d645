"""storage_tpu — commodity storage valuation framework for GPUs in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the reference
cmdty/storage library: storage facility modelling (ratchets, forced flows, fuel
consumption, inventory loss/cost, terminal constraints), intrinsic valuation,
one-factor trinomial tree, and multi-factor least-squares Monte Carlo with
deltas, expected profiles and trigger prices — built around sharded Monte
Carlo paths, psum-reduced normal-equation regressions and vmapped bang-bang
decision scans.
"""

from .facility import (
    CmdtyStorage,
    InventoryConstraintsCannotBeFulfilledException,
    InjectWithdrawRange,
    RatchetInterp,
)
from .constraints import (
    ConstantInjectWithdrawConstraint,
    InjectWithdrawRangeByInventory,
    InjectWithdrawRangeByInventoryAndPeriod,
    PiecewiseLinearInjectWithdrawConstraint,
    PolynomialInjectWithdrawConstraint,
    StepInjectWithdrawConstraint,
)
from .utils.discount import log_linear_discount_factors
from .api import intrinsic_value, trinomial_value, trinomial_deltas, IntrinsicValuationResults
from .api_lsmc import (
    three_factor_seasonal_value,
    multi_factor_value,
    value_from_sims,
    value_from_sims_host_local,
)
from .basis import (
    parse_basis_functions,
    BasisFunctionList,
    GenericBasisFunction,
    generic,
    MonomialBuilder,
    ONE,
    S,
    X,
    X0, X1, X2, X3, X4, X5, X6, X7, X8, X9,
    X_ST, X_LT, X_SW,
    spot_price_power,
    markov_factor_power,
)
from .lsmc_params import (
    LsmcValuationParameters,
    LsmcValuationParametersBuilder,
    MultiFactorSimSpec,
    PanelSimSpec,
    lsmc_value,
)
from .jobs import Job, JobCancelledError, JobControl, JobStatus, ValuationJobEngine
from .calc_service import CalcMode, CalcStatus, CalculationService, ObjectCache
from .curves import interpolate_curve_to_daily
from .models.multi_factor import MultiFactorModel
from .models.spot_sim import MultiFactorSpotSim
from .results import (
    DomesticCashFlow,
    InventoryRange,
    MultiFactorValuationResults,
    SimulationDataReturned,
    StorageProfile,
    TriggerPricePoint,
    TriggerPriceProfile,
    TriggerPrices,
)

__version__ = "0.5.0"

__all__ = [
    "CmdtyStorage",
    "RatchetInterp",
    "InjectWithdrawRange",
    "InventoryConstraintsCannotBeFulfilledException",
    "intrinsic_value",
    "trinomial_value",
    "trinomial_deltas",
    "IntrinsicValuationResults",
    "three_factor_seasonal_value",
    "multi_factor_value",
    "value_from_sims",
    "value_from_sims_host_local",
    "MultiFactorModel",
    "MultiFactorSpotSim",
    "MultiFactorValuationResults",
    "SimulationDataReturned",
    "TriggerPricePoint",
    "TriggerPriceProfile",
    "TriggerPrices",
    "StorageProfile",
    "DomesticCashFlow",
    "InventoryRange",
    "ConstantInjectWithdrawConstraint",
    "PiecewiseLinearInjectWithdrawConstraint",
    "PolynomialInjectWithdrawConstraint",
    "StepInjectWithdrawConstraint",
    "InjectWithdrawRangeByInventory",
    "InjectWithdrawRangeByInventoryAndPeriod",
    "log_linear_discount_factors",
    "parse_basis_functions",
    "GenericBasisFunction",
    "generic",
    "BasisFunctionList",
    "MonomialBuilder",
    "ONE", "S", "X",
    "X0", "X1", "X2", "X3", "X4", "X5", "X6", "X7", "X8", "X9",
    "X_ST", "X_LT", "X_SW",
    "spot_price_power",
    "markov_factor_power",
    "LsmcValuationParameters",
    "LsmcValuationParametersBuilder",
    "MultiFactorSimSpec",
    "PanelSimSpec",
    "lsmc_value",
    "Job",
    "JobCancelledError",
    "JobControl",
    "JobStatus",
    "ValuationJobEngine",
    "CalcMode",
    "CalcStatus",
    "CalculationService",
    "ObjectCache",
    "interpolate_curve_to_daily",
    "__version__",
]
