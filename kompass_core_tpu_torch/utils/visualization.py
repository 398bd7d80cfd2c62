"""Matplotlib-optional visualization helpers.

Role of the reference's ``utils/visualization.py``: plot paths, executed
trajectories, occupancy grids and planner solutions. All functions degrade
to a no-op warning when matplotlib is unavailable.
"""

import logging

import numpy as np

logger = logging.getLogger("kompass_core_tpu_torch")


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        logger.warning(
            "Matplotlib is required for visualization; skipping plot"
        )
        return None


def plot_paths(
    paths: dict,
    save_path: str = None,
    title: str = "Paths",
    ax=None,
):
    """Plot named (xs, ys) path tuples on one axis."""
    plt = _get_plt()
    if plt is None:
        return None
    own_fig = ax is None
    if own_fig:
        _, ax = plt.subplots()
    for name, (xs, ys) in paths.items():
        ax.plot(xs, ys, label=name)
    ax.set_xlabel("X [m]")
    ax.set_ylabel("Y [m]")
    ax.set_title(title)
    ax.grid(True)
    ax.legend()
    ax.set_aspect("equal")
    if save_path and own_fig:
        plt.savefig(save_path)
        plt.close()
    return ax


def plot_occupancy_grid(
    grid: np.ndarray, save_path: str = None, title: str = "Occupancy", ax=None
):
    plt = _get_plt()
    if plt is None:
        return None
    own_fig = ax is None
    if own_fig:
        _, ax = plt.subplots()
    ax.imshow(np.asarray(grid), origin="lower", cmap="gray_r")
    ax.set_title(title)
    if save_path and own_fig:
        plt.savefig(save_path)
        plt.close()
    return ax


def plot_trajectory_samples(
    paths_x: np.ndarray,
    paths_y: np.ndarray,
    best_index: int = None,
    save_path: str = None,
    ax=None,
):
    """Plot a batch of rollout samples [S, T] with the winner highlighted
    (role of the reference's DWA debugging-samples plot)."""
    plt = _get_plt()
    if plt is None:
        return None
    own_fig = ax is None
    if own_fig:
        _, ax = plt.subplots()
    for s in range(len(paths_x)):
        ax.plot(paths_x[s], paths_y[s], color="lightgray", linewidth=0.5)
    if best_index is not None:
        ax.plot(
            paths_x[best_index], paths_y[best_index], color="red", linewidth=2
        )
    ax.set_aspect("equal")
    ax.grid(True)
    if save_path and own_fig:
        plt.savefig(save_path)
        plt.close()
    return ax


# ---- reference-surface plotting helpers (utils/visualization.py:8-245) ----


def plt_map_obstacles(map, ax=None):
    """Plot a map's obstacles as filled circles (reference
    ``utils/visualization.py:8-29``)."""
    plt = _get_plt()
    if plt is None:
        return
    if not ax:
        ax = plt.gca()
    for idx, obs_x in enumerate(map.x_global):
        obs_y = map.y_global[idx]
        ax.add_patch(
            plt.Circle((obs_x, obs_y), map.occupied_zone[idx], color="k")
        )


def plt_path_sample(ref_path, label="", color="blue", marker="", ax=None):
    """Plot a PathSample as a line (reference
    ``utils/visualization.py:32-70``)."""
    plt = _get_plt()
    if plt is None:
        return
    import matplotlib.colors as PltColors
    import matplotlib.markers as PltMarkers

    if color not in PltColors.cnames:
        color = "blue"
    if marker not in PltMarkers.MarkerStyle.markers:
        marker = ""
    if not ax:
        ax = plt.gca()
    ax.plot(
        ref_path.x_points,
        ref_path.y_points,
        color=color,
        label=label,
        marker=marker,
    )


def plt_path_points_list(ref_path, label="", color="blue", marker="", ax=None):
    """Plot a list of PathPoint as a line (reference
    ``utils/visualization.py:73-113``)."""
    plt = _get_plt()
    if plt is None:
        return
    import matplotlib.colors as PltColors
    import matplotlib.markers as PltMarkers

    if color not in PltColors.cnames:
        color = "blue"
    if marker not in PltMarkers.MarkerStyle.markers:
        marker = ""
    if not ax:
        ax = plt.gca()
    ax.plot(
        [p.x for p in ref_path],
        [p.y for p in ref_path],
        color=color,
        label=label,
        marker=marker,
    )


_COLORS_DICT = {
    "red": [1.0, 0.0, 0.0],
    "green": [0.0, 1.0, 0.0],
    "blue": [0.0, 0.0, 1.0],
    "cyan": [0.0, 1.0, 1.0],
    "yellow": [1.0, 1.0, 0.0],
    "magenta": [1.0, 0.0, 1.0],
    "orange": [1.0, 0.644, 0],
    "white": [1.0, 1.0, 1.0],
    "black": [0.0, 0.0, 0.0],
    "dark_grey": [0.2, 0.2, 0.2],
    "grey": [0.5, 0.5, 0.5],
    "light_grey": [0.7, 0.7, 0.7],
}


def get_color(color_name: str, normalized: bool = False):
    """Named color as RGB, [0,1] when normalized else [0,255]
    (reference ``utils/visualization.py:160-176``)."""
    color = _COLORS_DICT[color_name]
    if normalized:
        return color
    return (np.array(color) * 255).tolist()


def _build_grid_colormap() -> np.ndarray:
    table = np.full((256, 3), 150, dtype=np.uint8)
    from ..datatypes.obstacles import OCCUPANCY_TYPE

    table[int(OCCUPANCY_TYPE.UNEXPLORED)] = get_color("dark_grey")
    table[int(OCCUPANCY_TYPE.EMPTY)] = get_color("grey")
    table[int(OCCUPANCY_TYPE.OCCUPIED)] = get_color("black")
    for i, name in enumerate(
        (
            "red",
            "green",
            "blue",
            "cyan",
            "yellow",
            "magenta",
            "orange",
            "white",
            "light_grey",
        ),
        start=1,
    ):
        table[i] = get_color(name)
    return table


MAPPING_GRID_TO_COLOR = _build_grid_colormap()


def visualize_grid(
    grid_data: np.ndarray,
    scale: float = 0.0,
    show_image: bool = False,
    save_file=None,
) -> np.ndarray:
    """Render an occupancy grid as an RGB image via the occupancy color
    table; optionally rescale, save, or show (reference
    ``utils/visualization.py:199-245``). Uses OpenCV when available,
    matplotlib image IO otherwise."""
    grid_image = MAPPING_GRID_TO_COLOR[np.asarray(grid_data)]
    try:
        import cv2

        if scale > 0:
            w = int(grid_image.shape[1] * scale)
            h = int(grid_image.shape[0] * scale)
            grid_image = cv2.resize(
                grid_image, (w, h), interpolation=cv2.INTER_AREA
            )
        if save_file:
            cv2.imwrite(save_file, cv2.cvtColor(grid_image, cv2.COLOR_RGB2BGR))
        if show_image:
            cv2.imshow("grid", cv2.cvtColor(grid_image, cv2.COLOR_RGB2BGR))
            cv2.waitKey(0)
    except ImportError:
        if scale > 0:
            reps = max(1, int(round(scale)))
            grid_image = np.repeat(
                np.repeat(grid_image, reps, axis=0), reps, axis=1
            )
        if save_file:
            plt = _get_plt()
            if plt is not None:
                plt.imsave(save_file, grid_image)
    return grid_image
