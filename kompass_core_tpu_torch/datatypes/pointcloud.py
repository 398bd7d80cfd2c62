"""3D point cloud container.

Covers the role of the reference's ``datatypes/pointcloud.py`` +
``utils/pointcloud.h`` (raw PointCloud2-style byte decoding). The decoded
representation is a dense ``[N, 3]`` float32 array — the layout every TPU
kernel in this package consumes.
"""

from typing import Optional

import numpy as np
from attrs import define, field

# PointField datatype codes (sensor_msgs/PointField convention)
_DTYPES = {
    1: np.int8,
    2: np.uint8,
    3: np.int16,
    4: np.uint16,
    5: np.int32,
    6: np.uint32,
    7: np.float32,
    8: np.float64,
}


@define
class PointCloudData:
    """Point cloud, stored dense as ``points [N, 3] float32``."""

    points: np.ndarray = field(default=np.zeros((0, 3), dtype=np.float32))

    @property
    def data(self) -> np.ndarray:
        return self.points

    @classmethod
    def from_bytes(
        cls,
        data: bytes,
        point_step: int,
        x_offset: int = 0,
        y_offset: int = 4,
        z_offset: int = 8,
        dtype_code: int = 7,
        row_step: Optional[int] = None,
        height: int = 1,
    ) -> "PointCloudData":
        """Decode raw PointCloud2-style bytes into an [N, 3] array.

        Equivalent behavior to the reference's raw-byte decode
        (``utils/pointcloud.h:49-116``): per-point strided field reads with
        configurable offsets and datatype, cast to float32.
        """
        dt = _DTYPES[dtype_code]
        buf = np.frombuffer(data, dtype=np.uint8)
        itemsize = np.dtype(dt).itemsize
        # mirror the reference's row walk (``pointcloud.h:135-146``):
        # point k of row r starts at r*row_step + k*point_step, for
        # k*point_step < row_step — row_step is the ROW STRIDE, so rows
        # with padding stay aligned; a final point overlapping the pad is
        # kept iff it fits in the buffer (the reference's max_offset
        # guard, same semantics)
        if row_step is None:
            row_step = buf.size
            height = 1
        cols = np.arange(0, row_step, point_step, dtype=np.int64)
        starts = (
            np.arange(height, dtype=np.int64)[:, None] * row_step
            + cols[None, :]
        ).ravel()
        max_off = max(x_offset, y_offset, z_offset) + itemsize
        starts = starts[starts + max_off <= buf.size]

        def read_field(offset):
            idx = starts[:, None] + offset + np.arange(itemsize)
            return (
                np.ascontiguousarray(buf[idx])
                .view(dt)
                .reshape(len(starts))
                .astype(np.float32)
            )

        pts = np.stack(
            [read_field(x_offset), read_field(y_offset), read_field(z_offset)],
            axis=1,
        )
        return cls(points=pts)

    def filtered(
        self,
        z_min: float = -np.inf,
        z_max: float = np.inf,
        drop_nonfinite: bool = True,
    ) -> np.ndarray:
        pts = self.points
        mask = (pts[:, 2] >= z_min) & (pts[:, 2] <= z_max)
        if drop_nonfinite:
            mask &= np.isfinite(pts).all(axis=1)
        return pts[mask]


def pointcloud_to_laserscan_from_raw(
    data,
    point_step: int,
    row_step: int,
    height: int,
    width: int,
    x_offset: int,
    y_offset: int,
    z_offset: int,
    max_range: float,
    min_z: float,
    max_z: float,
    angle_step: Optional[float] = None,
    num_bins: Optional[int] = None,
):
    """Raw PointCloud2-style bytes -> laserscan bins (per-bin min range).

    Port of the reference's two ``pointcloud_to_laserscan_from_raw``
    overloads (``bindings_utils.cpp:76-121``, ``utils/pointcloud.h``):

    - with ``angle_step``: bins are ``angle_step`` wide (the last bin
      absorbs the remainder when 2*pi is not an exact multiple); returns
      ``(ranges, angles)`` with angles at each bin start in [0, 2*pi).
    - with ``num_bins``: uniform ``2*pi/num_bins`` bins; returns ranges
      only.

    Semantics preserved exactly: iterate ``row_step`` bytes per row in
    ``point_step`` strides (``width`` is informational, as upstream),
    skip points whose x/y/z reads would run out of bounds, drop
    near-origin points (r^2 < 1e-6), apply the z filter where a NEGATIVE
    ``max_z`` disables the ceiling, and keep the per-bin minimum distance
    with ``max_range`` as the empty-bin value.
    """
    if (angle_step is None) == (num_bins is None):
        raise TypeError("pass exactly one of angle_step or num_bins")
    two_pi = 2.0 * np.pi
    if angle_step is not None:
        n_bins = int(np.ceil(two_pi / angle_step))
        bin_width = float(angle_step)
    else:
        n_bins = int(num_bins)
        bin_width = two_pi / n_bins

    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(data, np.uint8)
    else:
        # accept int8 arrays (the reference's std::vector<int8_t>) AND
        # plain lists of 0..255 byte values (ROS message payloads) —
        # astype wraps both signed and unsigned representations;
        # copy=False keeps already-uint8 multi-MB clouds zero-copy
        buf = np.asarray(data).astype(np.uint8, copy=False).ravel()
    ranges = np.full(n_bins, float(max_range))
    angles = np.arange(n_bins) * bin_width

    cols = np.arange(0, row_step, point_step, dtype=np.int64)
    starts = (
        np.arange(height, dtype=np.int64)[:, None] * row_step + cols[None, :]
    ).ravel()
    max_field = max(x_offset, y_offset, z_offset)
    starts = starts[starts + max_field + 4 <= buf.size]
    if starts.size == 0:
        return (ranges, angles) if angle_step is not None else ranges

    def f32_at(off: int) -> np.ndarray:
        block = buf[starts[:, None] + (off + np.arange(4))[None, :]]
        return np.ascontiguousarray(block).view("<f4").ravel()

    x = f32_at(x_offset)
    y = f32_at(y_offset)
    z = f32_at(z_offset)
    r2 = x.astype(np.float64) ** 2 + y.astype(np.float64) ** 2
    ok = (r2 >= 1e-6) & (z >= min_z)
    if max_z >= 0.0:
        ok &= z <= max_z
    if not np.any(ok):
        return (ranges, angles) if angle_step is not None else ranges
    ang = np.arctan2(y[ok].astype(np.float64), x[ok].astype(np.float64))
    ang = np.where(ang < 0.0, ang + two_pi, ang)
    bins = np.minimum((ang / bin_width).astype(np.int64), n_bins - 1)
    dist = np.sqrt(r2[ok])
    np.minimum.at(ranges, bins, np.minimum(dist, float(max_range)))
    return (ranges, angles) if angle_step is not None else ranges
