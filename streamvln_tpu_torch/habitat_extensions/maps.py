"""Occupancy-grid top-down map rendering over habitat's map API (the
port's twin of `streamvln_tpu/habitat_extensions/maps.py`, numpy as
there).

Reference: streamvln/habitat_extensions/maps.py:49-390 — colorizes
habitat's real navmesh top-down map (get_topdown_map over the
pathfinder) with the VLN-CE palette, then draws the reference path
(dashed), source/target markers, the agent's trajectory, and an agent
triangle. The semantic map-ID constants and palette ARE the spec and
match the reference exactly; the rasterization here is PIL/numpy
(the reference uses cv2, not shipped in this image).

Everything below draws into an index-valued uint8 grid first and
colorizes at the end, exactly like the reference pipeline
(get_top_down_map -> draw_* -> colorize_top_down_map).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MAP_THICKNESS_SCALAR: int = 128

MAP_INVALID_POINT = 0
MAP_VALID_POINT = 1
MAP_BORDER_INDICATOR = 2
MAP_SOURCE_POINT_INDICATOR = 4
MAP_TARGET_POINT_INDICATOR = 6
MAP_MP3D_WAYPOINT = 7
MAP_VIEW_POINT_INDICATOR = 8
MAP_TARGET_BOUNDING_BOX = 9
MAP_REFERENCE_POINT = 10
MAP_MP3D_REFERENCE_PATH = 11
MAP_WAYPOINT_PREDICTION = 12
MAP_ORACLE_WAYPOINT = 13
MAP_SHORTEST_PATH_WAYPOINT = 14
MAP_AGENT_PATH_START = 15   # 15..255: trajectory gradient (jet)


def _jet(n: int = 241) -> np.ndarray:
    """cv2.COLORMAP_JET equivalent (uint8 RGB ramp), pure numpy."""
    x = np.linspace(0.0, 1.0, n)

    def channel(c):
        return np.clip(1.5 - np.abs(4.0 * x - c), 0.0, 1.0)

    r, g, b = channel(3.0), channel(2.0), channel(1.0)
    return (np.stack([r, g, b], 1) * 255).astype(np.uint8)


TOP_DOWN_MAP_COLORS = np.full((256, 3), 150, dtype=np.uint8)
TOP_DOWN_MAP_COLORS[15:] = _jet(241)
TOP_DOWN_MAP_COLORS[MAP_INVALID_POINT] = [255, 255, 255]
TOP_DOWN_MAP_COLORS[MAP_VALID_POINT] = [150, 150, 150]
TOP_DOWN_MAP_COLORS[MAP_BORDER_INDICATOR] = [50, 50, 50]
TOP_DOWN_MAP_COLORS[MAP_SOURCE_POINT_INDICATOR] = [0, 0, 200]
TOP_DOWN_MAP_COLORS[MAP_TARGET_POINT_INDICATOR] = [200, 0, 0]
TOP_DOWN_MAP_COLORS[MAP_MP3D_WAYPOINT] = [0, 200, 0]
TOP_DOWN_MAP_COLORS[MAP_VIEW_POINT_INDICATOR] = [245, 150, 150]
TOP_DOWN_MAP_COLORS[MAP_TARGET_BOUNDING_BOX] = [0, 175, 0]
TOP_DOWN_MAP_COLORS[MAP_REFERENCE_POINT] = [0, 0, 0]
TOP_DOWN_MAP_COLORS[MAP_MP3D_REFERENCE_PATH] = [0, 0, 0]
TOP_DOWN_MAP_COLORS[MAP_WAYPOINT_PREDICTION] = [255, 255, 0]
TOP_DOWN_MAP_COLORS[MAP_ORACLE_WAYPOINT] = [255, 165, 0]
TOP_DOWN_MAP_COLORS[MAP_SHORTEST_PATH_WAYPOINT] = [0, 150, 0]


def colorize_top_down_map(
    top_down_map: np.ndarray,
    fog_of_war_mask: Optional[np.ndarray] = None,
    fog_of_war_desat_amount: float = 0.5,
) -> np.ndarray:
    """Index grid -> RGB; unseen valid cells desaturate
    (reference maps.py:62-83, identical semantics)."""
    _map = TOP_DOWN_MAP_COLORS[top_down_map]
    if fog_of_war_mask is not None:
        desat = np.array([[fog_of_war_desat_amount], [1.0]])
        desat_mask = top_down_map != MAP_INVALID_POINT
        _map[desat_mask] = (_map * desat[fog_of_war_mask]).astype(
            np.uint8)[desat_mask]
    return _map


def static_to_grid(realworld_x: float, realworld_y: float,
                   grid_resolution: Tuple[int, int],
                   bounds: Dict[str, Sequence[float]]) -> Tuple[int, int]:
    """Habitat world (z, x) -> grid (row, col) with static bounds
    (reference maps.py:86-112). `realworld_x` is the habitat z
    coordinate, `realworld_y` the habitat x — the reference's calling
    convention (to_grid(p[2], p[0], ...))."""
    grid_size = (
        abs(bounds["upper"][2] - bounds["lower"][2]) / grid_resolution[0],
        abs(bounds["upper"][0] - bounds["lower"][0]) / grid_resolution[1],
    )
    grid_x = int((realworld_x - bounds["lower"][2]) / grid_size[0])
    grid_y = int((realworld_y - bounds["lower"][0]) / grid_size[1])
    return grid_x, grid_y


def sim_bounds(sim) -> Dict[str, np.ndarray]:
    lower, upper = sim.pathfinder.get_bounds()
    return {"lower": np.asarray(lower), "upper": np.asarray(upper)}


def _line_points(pt1, pt2, gap: float) -> List[Tuple[int, int]]:
    dist = float(np.hypot(pt1[0] - pt2[0], pt1[1] - pt2[1]))
    if dist == 0:
        return [(int(pt1[0]), int(pt1[1]))]
    pts = []
    for i in np.arange(0, dist, gap):
        r = i / dist
        pts.append((int(pt1[0] * (1 - r) + pt2[0] * r + 0.5),
                    int(pt1[1] * (1 - r) + pt2[1] * r + 0.5)))
    return pts


def drawline(img: np.ndarray, pt1, pt2, color: int,
             thickness: int = 1, style: str = "dotted",
             gap: int = 15) -> None:
    """Dotted/dashed/filled segment into the index grid
    (reference maps.py:115-151; cv2-free: dense point interpolation).
    Points are (x, y) = (col, row), the cv2 convention."""
    assert style in ("dotted", "dashed", "filled")
    if style == "filled":
        for x, y in _line_points(pt1, pt2, 1.0):
            _stamp(img, y, x, color, thickness)
        return
    pts = _line_points(pt1, pt2, gap)
    if style == "dotted":
        for x, y in pts:
            _stamp(img, y, x, color, thickness)
    else:  # dashed: joins alternating point pairs
        for i in range(1, len(pts), 2):
            for x, y in _line_points(pts[i - 1], pts[i], 1.0):
                _stamp(img, y, x, color, thickness)


def _stamp(img: np.ndarray, row: int, col: int, color: int,
           radius: int) -> None:
    r0, r1 = max(row - radius, 0), min(row + radius + 1, img.shape[0])
    c0, c1 = max(col - radius, 0), min(col + radius + 1, img.shape[1])
    if r0 < r1 and c0 < c1:
        img[r0:r1, c0:c1] = color


def drawpoint(img: np.ndarray, position, color: int,
              meters_per_px: float, pad: float = 0.3) -> None:
    """Square marker, pad meters wide (reference maps.py:154-167).
    `position` is (row, col)."""
    point_padding = int(pad / meters_per_px)
    img[max(position[0] - point_padding, 0):
        position[0] + point_padding + 1,
        max(position[1] - point_padding, 0):
        position[1] + point_padding + 1] = color


def draw_triangle(img: np.ndarray, centroid, color: int,
                  meters_per_px: float, pad: float = 0.35) -> None:
    """Upward triangle marker (reference maps.py:170-183), rasterized
    by barycentric containment. `centroid` is (row, col)."""
    p = int(pad / meters_per_px)
    row_c, col_c = centroid
    # vertices (row, col): two base corners below, apex above
    v = np.array([[row_c + p, col_c - p],
                  [row_c + p, col_c + p],
                  [row_c - p, col_c]], np.float64)
    r0 = max(int(v[:, 0].min()), 0)
    r1 = min(int(v[:, 0].max()) + 1, img.shape[0])
    c0 = max(int(v[:, 1].min()), 0)
    c1 = min(int(v[:, 1].max()) + 1, img.shape[1])
    if r0 >= r1 or c0 >= c1:
        return
    rr, cc = np.mgrid[r0:r1, c0:c1]

    def edge(a, b):
        return ((cc - a[1]) * (b[0] - a[0])
                - (rr - a[0]) * (b[1] - a[1]))

    e0, e1, e2 = edge(v[0], v[1]), edge(v[1], v[2]), edge(v[2], v[0])
    inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
             ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    img[r0:r1, c0:c1][inside] = color


def get_top_down_map(sim, map_resolution: int,
                     meters_per_pixel: Optional[float]) -> np.ndarray:
    """Navmesh occupancy grid at the agent's height (reference
    maps.py:49-59: habitat_maps.get_topdown_map over the pathfinder)."""
    from habitat.utils.visualizations import maps as habitat_maps
    base_height = sim.get_agent(0).state.position[1]
    return habitat_maps.get_topdown_map(
        sim.pathfinder, base_height, map_resolution, False,
        meters_per_pixel)


def draw_reference_path(img: np.ndarray, bounds, episode,
                        map_resolution: int,
                        meters_per_px: float) -> None:
    """Dashed lines between reference-path waypoints + waypoint squares
    (reference maps.py:186-221)."""
    pts = [static_to_grid(p[2], p[0], img.shape[0:2], bounds)[::-1]
           for p in episode.reference_path]
    thickness = max(int(0.4 * map_resolution / MAP_THICKNESS_SCALAR), 1)
    for pt_from, pt_to in zip(pts, pts[1:]):
        drawline(img, pt_from, pt_to, MAP_SHORTEST_PATH_WAYPOINT,
                 thickness=thickness, style="dashed", gap=10)
    for pt in pts:
        drawpoint(img, (pt[1], pt[0]), MAP_SHORTEST_PATH_WAYPOINT,
                  meters_per_px)


def draw_source_and_target(img: np.ndarray, bounds, episode,
                           meters_per_px: float) -> None:
    """Blue source square, red target square (maps.py:236-253)."""
    s = static_to_grid(episode.start_position[2],
                       episode.start_position[0], img.shape[0:2], bounds)
    drawpoint(img, s, MAP_SOURCE_POINT_INDICATOR, meters_per_px)
    t = static_to_grid(episode.goals[0].position[2],
                       episode.goals[0].position[0], img.shape[0:2],
                       bounds)
    drawpoint(img, t, MAP_TARGET_POINT_INDICATOR, meters_per_px)


def draw_agent_path(img: np.ndarray, bounds,
                    path: Sequence[Sequence[float]]) -> None:
    """Agent trajectory as a jet-gradient polyline: early steps blue,
    late steps red (the reference's TopDownMap measure assigns
    TOP_DOWN_MAP_COLORS[15:] along the path the same way)."""
    if len(path) < 2:
        return
    pts = [static_to_grid(p[2], p[0], img.shape[0:2], bounds)[::-1]
           for p in path]
    n = len(pts) - 1
    for i, (a, b) in enumerate(zip(pts, pts[1:])):
        color = MAP_AGENT_PATH_START + int(
            (255 - MAP_AGENT_PATH_START) * i / max(n - 1, 1))
        drawline(img, a, b, color, thickness=1, style="filled")


def render_episode_map(sim, episode,
                       agent_path: Sequence[Sequence[float]],
                       map_resolution: int = 512,
                       meters_per_pixel: Optional[float] = None,
                       occupancy: Optional[np.ndarray] = None,
                       fog_of_war_mask: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """Full episode map: occupancy grid + reference path + endpoints +
    trajectory + agent triangle -> RGB uint8.

    `occupancy` overrides the habitat get_topdown_map call (hosts
    without habitat-sim pass a precomputed/synthetic grid)."""
    if occupancy is None:
        occupancy = get_top_down_map(sim, map_resolution,
                                     meters_per_pixel)
    img = occupancy.astype(np.uint8).copy()
    bounds = sim_bounds(sim)
    span_m = abs(bounds["upper"][2] - bounds["lower"][2])
    meters_per_px = span_m / img.shape[0]
    if getattr(episode, "reference_path", None):
        draw_reference_path(img, bounds, episode, map_resolution,
                            meters_per_px)
    draw_source_and_target(img, bounds, episode, meters_per_px)
    if agent_path is not None and len(agent_path):
        draw_agent_path(img, bounds, agent_path)
        last = static_to_grid(agent_path[-1][2], agent_path[-1][0],
                              img.shape[0:2], bounds)
        draw_triangle(img, last, MAP_WAYPOINT_PREDICTION, meters_per_px)
    return colorize_top_down_map(img, fog_of_war_mask)
