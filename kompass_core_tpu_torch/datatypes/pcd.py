"""PCD (Point Cloud Data) file reading and occupancy-grid conversion.

Role of the reference's ``readPCD`` / ``readPCDToOccupancyGrid``
(``kompass_cpp/include/utils/pointcloud.h:287-541``) and the Python
front-end wrappers ``get_points_from_pcd`` / ``get_occupancy_grid_from_pcd``
(``kompass_core/datatypes/pointcloud.py:8-34``). Pure NumPy host code —
this is offline map-ingestion tooling, not a device hot path.

Supported subset mirrors the reference exactly: ``ascii`` and ``binary``
DATA formats, ``x``/``y``/``z`` FIELDS extracted, other fields ignored,
one element per field (no COUNT > 1), x/y/z stored as 4-byte floats in
binary files.

Intentional divergence (corrected redesign): the reference's ascii branch
reads three whitespace-separated tokens per point regardless of the FIELDS
layout (``pointcloud.h:397-418``), silently misparsing ascii files that
carry extra fields. Here the ascii branch honours the declared field
positions, so extra-field ascii files parse correctly; for the plain
``x y z`` layout every value is bit-identical to the reference.
"""

from typing import Optional, Tuple

import numpy as np

from .obstacles import OCCUPANCY_TYPE

__all__ = [
    "read_pcd",
    "read_pcd_to_occupancy_grid",
    "get_points_from_pcd",
    "get_occupancy_grid_from_pcd",
]


def _parse_header(blob: bytes):
    """Parses the PCD header out of the raw file bytes.

    Returns (fields, sizes, num_points, data_format, data_start_offset)
    or None when the header is malformed (no DATA line). Mirrors the
    reference's keyword handling (``pointcloud.h:304-358``): empty and
    ``#``-comment lines are skipped, only FIELDS/SIZE/POINTS/DATA are
    interpreted, parsing stops at the DATA line.
    """
    fields = []
    sizes = []
    num_points = 0
    data_format: Optional[str] = None
    pos = 0
    n = len(blob)
    while pos < n:
        eol = blob.find(b"\n", pos)
        if eol == -1:
            eol = n
        line = blob[pos:eol].rstrip(b"\r")
        pos = eol + 1
        if not line or line.startswith(b"#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        keyword = parts[0]
        if keyword == b"FIELDS":
            fields = [p.decode("ascii", "replace") for p in parts[1:]]
        elif keyword == b"SIZE":
            try:
                sizes = [int(p) for p in parts[1:]]
            except ValueError:
                return None
        elif keyword == b"POINTS":
            try:
                num_points = int(parts[1])
            except ValueError:
                return None
        elif keyword == b"DATA":
            data_format = parts[1].decode("ascii", "replace")
            break
    if data_format is None:
        return None
    return fields, sizes, num_points, data_format, pos


def read_pcd(filename: str) -> Optional[np.ndarray]:
    """Reads a PCD file and extracts its 3D points.

    Returns an ``[N, 3] float32`` array of (x, y, z), or ``None`` when the
    file cannot be opened, is malformed, is missing x/y/z fields, or uses
    an unsupported DATA format — the reference's ``std::nullopt`` contract
    (``pointcloud.h:287-434``).
    """
    try:
        with open(filename, "rb") as f:
            blob = f.read()
    except OSError:
        return None

    header = _parse_header(blob)
    if header is None:
        return None
    fields, sizes, num_points, data_format, data_start = header

    try:
        x_idx = fields.index("x")
        y_idx = fields.index("y")
        z_idx = fields.index("z")
    except ValueError:
        return None

    if data_format == "ascii":
        tokens = blob[data_start:].split()
        n_fields = len(fields) if fields else 3
        if len(tokens) < num_points * n_fields:
            # mirror the reference's tolerance: missing trailing values
            # parse as 0.0 rather than failing the whole file
            tokens = tokens + [b"0"] * (num_points * n_fields - len(tokens))
        try:
            vals = np.array(
                [float(t) for t in tokens[: num_points * n_fields]],
                dtype=np.float32,
            ).reshape(num_points, n_fields)
        except ValueError:
            # non-numeric token: malformed body -> None per the
            # documented contract (not an uncaught ValueError)
            return None
        return np.ascontiguousarray(vals[:, [x_idx, y_idx, z_idx]])

    if data_format == "binary":
        if len(fields) != len(sizes):
            return None
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        stride = int(offsets[-1])
        raw = blob[data_start : data_start + num_points * stride]
        if len(raw) != num_points * stride:
            return None
        mat = np.frombuffer(raw, dtype=np.uint8).reshape(num_points, stride)
        out = np.empty((num_points, 3), dtype=np.float32)
        for j, idx in enumerate((x_idx, y_idx, z_idx)):
            off = int(offsets[idx])
            out[:, j] = (
                mat[:, off : off + 4]
                .copy()
                .view(np.float32)
                .reshape(num_points)
            )
        return out

    return None


def read_pcd_to_occupancy_grid(
    filename: str,
    grid_resolution: float,
    z_ground_limit: float,
    robot_height: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Converts a PCD file to a 2D occupancy grid.

    Port of ``readPCDToOccupancyGrid`` (``pointcloud.h:469-541``): cells
    are classified per point by height — OCCUPIED (100) for
    ``z_ground_limit < z <= robot_height``, EMPTY (0) for
    ``z <= z_ground_limit``, UNEXPLORED (-1) above ``robot_height`` — and
    combined per cell with max (occupied wins over free wins over unknown).
    Returns ``(grid int8 [num_cells_x, num_cells_y], origin float32 [3])``
    where origin is ``(min_x, min_y, 0)``.

    Raises RuntimeError when the file cannot be read (the reference throws
    ``std::runtime_error``, ``pointcloud.h:476``).
    """
    points = read_pcd(filename)
    if points is None:
        raise RuntimeError(f"Failed to read PCD file: {filename}")
    if points.shape[0] == 0:
        return (
            np.zeros((0, 0), dtype=np.int8),
            np.zeros(3, dtype=np.float32),
        )

    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    min_x, max_x = float(x.min()), float(x.max())
    min_y, max_y = float(y.min()), float(y.max())
    cell_num_x = int(np.ceil((max_x - min_x) / grid_resolution))
    cell_num_y = int(np.ceil((max_y - min_y) / grid_resolution))

    grid = np.full(
        (cell_num_x, cell_num_y),
        int(OCCUPANCY_TYPE.UNEXPLORED),
        dtype=np.int8,
    )

    inv_res = 1.0 / grid_resolution
    # C-style truncation toward zero; offsets are non-negative so this is
    # a floor, and points at the exact max edge fall outside the grid and
    # are dropped by the bounds mask — identical to the reference's
    # ``cell_x < cell_num_x`` check (pointcloud.h:520-522)
    cx = ((x - np.float32(min_x)) * np.float32(inv_res)).astype(np.int32)
    cy = ((y - np.float32(min_y)) * np.float32(inv_res)).astype(np.int32)
    in_bounds = (cx >= 0) & (cx < cell_num_x) & (cy >= 0) & (cy < cell_num_y)

    z_val = np.where(
        (z > z_ground_limit) & (z <= robot_height),
        np.int8(OCCUPANCY_TYPE.OCCUPIED),
        np.where(
            z <= z_ground_limit,
            np.int8(OCCUPANCY_TYPE.EMPTY),
            np.int8(OCCUPANCY_TYPE.UNEXPLORED),
        ),
    ).astype(np.int8)

    np.maximum.at(grid, (cx[in_bounds], cy[in_bounds]), z_val[in_bounds])
    return grid, np.array([min_x, min_y, 0.0], dtype=np.float32)


def get_points_from_pcd(file_path: str) -> np.ndarray:
    """Read point cloud data from a pcd file.

    Front-end wrapper matching ``get_points_from_pcd``
    (``kompass_core/datatypes/pointcloud.py:8-13``); raises RuntimeError on
    failure like the reference binding (``bindings_utils.cpp:16-21``).
    """
    points = read_pcd(file_path)
    if points is None:
        raise RuntimeError(f"Failed to read PCD file: {file_path}")
    return points


def get_occupancy_grid_from_pcd(
    file_path: str,
    grid_resolution: float,
    z_ground_limit: float,
    robot_height: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Read an occupancy grid directly from a pcd file
    (``kompass_core/datatypes/pointcloud.py:16-34``)."""
    return read_pcd_to_occupancy_grid(
        file_path, grid_resolution, z_ground_limit, robot_height
    )
