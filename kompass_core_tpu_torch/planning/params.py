"""Per-planner parameter introspection + auto-generated config classes.

Mirror of the reference's OMPL param machinery
(``third_party/ompl/config.py``): every registered planner exposes a
parameter map of ``name -> (display_name, type_code, range_suggestion,
default)`` tuples in the exact shape the reference builds from
``Planner::params()`` introspection, and ``create_config_class`` turns a
map into a validated attrs config class (``config.py:129-184``).

Unlike the reference (whose bindings read the ranges back from OMPL at
runtime), the maps here are authored with each algorithm — but every
parameter listed is HONORED by the corresponding solver in
``planner.py`` / ``planners_ext.py``; none are decorative.
"""

from typing import Any, Dict

from attrs import field, make_class

from ..utils.config import BaseAttrs, base_validators


class ParamType:
    """Type codes (reference ``config.py:10-17`` PlanningAlgorithms)."""

    UNKNOWN = 0
    BOOL = 1
    ENUM = 2
    INT = 3
    DOUBLE = 4


_D = ParamType.DOUBLE
_I = ParamType.INT
_B = ParamType.BOOL

# ``range`` (extension step) uses 0.0 = inherit GlobalPlannerConfig.step_size,
# the same convention as OMPL's auto-configured range.
_RANGE = ("Range", _D, [0.0, 0.01, 100.0], 0.0)
_GOAL_BIAS = ("Goal bias", _D, [0.0, 0.05, 1.0], 0.05)
_REWIRE = ("Rewire factor", _D, [1.0, 0.01, 3.0], 1.1)

PLANNER_PARAMS: Dict[str, Dict[str, tuple]] = {
    "PRM": {
        "max_nearest_neighbors": ("Max nearest neighbors (0 = uncapped)", _I, [0, 1, 1000], 16),
    },
    "LazyPRM": {
        "max_nearest_neighbors": ("Max nearest neighbors (0 = uncapped)", _I, [0, 1, 1000], 16),
        "range": _RANGE,
    },
    "PRMstar": {
        "rewire_factor": _REWIRE,
    },
    "LazyPRMstar": {
        "rewire_factor": _REWIRE,
    },
    "RRT": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
    },
    "RRTstar": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "rewire_factor": _REWIRE,
    },
    # (OMPL's number_sampling_attempts is deliberately NOT exposed: it
    # bounds rejection sampling of the informed set, and this build
    # samples the prolate hyperspheroid directly — no rejection loop)
    "InformedRRTstar": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "rewire_factor": _REWIRE,
    },
    "RRTConnect": {
        "range": _RANGE,
        "connect_steps": ("Connect steps", _I, [1, 1, 64], 8),
    },
    "LazyRRT": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
    },
    "LBTRRT": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "rewire_factor": _REWIRE,
        "epsilon": ("Epsilon", _D, [0.0, 0.01, 10.0], 0.4),
    },
    "LazyLBTRRT": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "rewire_factor": _REWIRE,
        "epsilon": ("Epsilon", _D, [0.0, 0.01, 10.0], 0.4),
    },
    "RRTsharp": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "rewire_factor": _REWIRE,
    },
    "RRTXstatic": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "rewire_factor": _REWIRE,
        "epsilon_consistency": (
            "Epsilon consistency", _D, [0.0, 0.001, 1.0], 0.02,
        ),
    },
    "EST": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "density_radius": ("Density radius", _D, [0.01, 0.01, 100.0], 1.0),
    },
    "KPIECE1": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "border_fraction": ("Border fraction", _D, [0.0, 0.05, 1.0], 0.9),
    },
    "SST": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "selection_radius": ("Selection radius", _D, [0.01, 0.01, 100.0], 1.0),
        "pruning_radius": ("Pruning radius", _D, [0.01, 0.01, 100.0], 0.3),
    },
    "FMTstar": {
        "num_samples": ("Num samples", _I, [16, 1, 8192], 512),
        "radius_multiplier": (
            "Radius multiplier", _D, [0.1, 0.05, 10.0], 1.1,
        ),
    },
    "BITstar": {
        "samples_per_batch": ("Samples per batch", _I, [16, 1, 4096], 128),
        "batches": ("Batches", _I, [1, 1, 64], 4),
        "rewire_factor": _REWIRE,
    },
    "TRRT": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
        "init_temperature": ("Init temperature", _D, [1e-6, 1.0, 1e6], 100.0),
        # 0.0 = auto (quarter of the extension step)
        "frontier_threshold": (
            "Frontier threshold", _D, [0.0, 0.01, 100.0], 0.0,
        ),
    },
    "BiEST": {
        "range": _RANGE,
        # 0.0 = auto (density neighborhood = the extension range)
        "density_radius": ("Density radius", _D, [0.0, 0.01, 100.0], 0.0),
    },
    "SBL": {
        "range": _RANGE,
    },
    "BKPIECE1": {
        "range": _RANGE,
        "border_fraction": ("Border fraction", _D, [0.0, 0.05, 1.0], 0.9),
    },
    "LBKPIECE1": {
        "range": _RANGE,
        "border_fraction": ("Border fraction", _D, [0.0, 0.05, 1.0], 0.9),
    },
    "ProjEST": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
    },
    "PDST": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
    },
    "STRIDE": {
        "range": _RANGE,
        "goal_bias": _GOAL_BIAS,
    },
    "BFMT": {
        "num_samples": ("Num samples", _I, [16, 1, 8192], 512),
        "radius_multiplier": (
            "Radius multiplier", _D, [0.1, 0.05, 10.0], 1.1,
        ),
    },
    "ABITstar": {
        "samples_per_batch": ("Samples per batch", _I, [16, 1, 4096], 128),
        "batches": ("Batches", _I, [1, 1, 64], 4),
        "rewire_factor": _REWIRE,
        "initial_inflation": (
            "Initial inflation", _D, [1.0, 0.1, 1e6], 2.0,
        ),
    },
    "AITstar": {
        "samples_per_batch": ("Samples per batch", _I, [16, 1, 4096], 128),
        "batches": ("Batches", _I, [1, 1, 64], 4),
        "rewire_factor": _REWIRE,
    },
}

# "FMT" is the OMPL class name; "FMTstar" the descriptive alias — one map
PLANNER_PARAMS["FMT"] = PLANNER_PARAMS["FMTstar"]


def create_field(input_tuple: tuple):
    """One attrs field from an OMPL-style param tuple
    (reference ``config.py:129-159``)."""
    type_code = input_tuple[1]
    rng = input_tuple[2]
    default = input_tuple[3]
    if type_code == ParamType.BOOL:
        return field(type=bool, default=bool(default))
    if type_code == ParamType.ENUM:
        return field(
            type=type(default),
            default=default,
            validator=base_validators.in_(rng),
        )
    py_type: Any = int if type_code == ParamType.INT else float
    if rng:
        min_val, _step, max_val = rng
        return field(
            type=py_type,
            default=py_type(default),
            validator=base_validators.in_range(min_val, max_val),
        )
    return field(type=py_type, default=py_type(default))


_class_cache: Dict[str, type] = {}


def create_config_class(name: str, conf: Dict[str, tuple]) -> type:
    """BaseAttrs config class from a planner parameter map
    (reference ``config.py:161-184``)."""
    if name not in _class_cache:
        fields = {key: create_field(val) for key, val in conf.items()}
        from attrs import setters

        # validate on setattr too: configure()/from_file load params via
        # plain attribute assignment, which make_class classes (unlike
        # @define) do not validate by default — an out-of-range yaml value
        # (e.g. goal_bias: 5.0) would silently degenerate the planner
        _class_cache[name] = make_class(
            name + "Config",
            fields,
            bases=(BaseAttrs,),
            on_setattr=[setters.convert, setters.validate],
        )
    return _class_cache[name]


def default_planner_params(planner_id: str):
    """Instantiate the default per-planner config for a registry id."""
    conf = PLANNER_PARAMS.get(planner_id)
    if conf is None:
        return None
    return create_config_class(planner_id, conf)()
