from ..ops.mapping import EMPTY, OCCUPIED, UNEXPLORED  # noqa: F401
from .local_mapper import GridData, LocalMapper, MapConfig  # noqa: F401


class OCCUPANCY_TYPE:
    """Occupancy codes (reference ``mapping/local_mapper.h:9``)."""

    class _V:
        def __init__(self, value):
            self.value = value

    UNEXPLORED = _V(UNEXPLORED)
    EMPTY = _V(EMPTY)
    OCCUPIED = _V(OCCUPIED)
