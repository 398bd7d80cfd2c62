from .angles import normalize_to_0_2pi, normalize_to_minus_pi_pi  # noqa: F401
from .config import BaseAttrs, base_validators  # noqa: F401
