"""Procedural terrain generation (host-side numpy, build-time).

A copy of `isaacgymenv_tpu/utils/terrain.py` (the port imports nothing of
the JAX package): the `isaacgym.terrain_utils` sub-terrain generators
consumed by the terrain tasks plus the task-level `TerrainGrid` composer, a
(levels x types) grid of sub-terrains with curriculum difficulty rows, int16
raw heightfields and per-cell env origins.  The same config and seed give
the same `height_field_raw` and `env_origins`, bit for bit, as the JAX
package's copy.  The sim collides against the heightfield directly
(`physics/contact.py` `Heightfield`).

All functions take/return int16 height units of `vertical_scale` meters on a
`horizontal_scale` grid, matching the reference convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SubTerrain:
    terrain_name: str = "terrain"
    width: int = 256           # pixels along x
    length: int = 256          # pixels along y
    vertical_scale: float = 0.005
    horizontal_scale: float = 0.1
    height_field_raw: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.height_field_raw is None:
            self.height_field_raw = np.zeros((self.width, self.length), dtype=np.int16)


def random_uniform_terrain(
    terrain: SubTerrain,
    min_height: float,
    max_height: float,
    step: float = 1.0,
    downsampled_scale: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> SubTerrain:
    """Uniform noise sampled on a coarse grid, linearly upsampled."""
    rng = rng or np.random.default_rng()
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    min_h = int(min_height / terrain.vertical_scale)
    max_h = int(max_height / terrain.vertical_scale)
    step_h = max(int(step / terrain.vertical_scale), 1)
    heights_range = np.arange(min_h, max_h + step_h, step_h)

    ds = max(int(downsampled_scale / terrain.horizontal_scale), 1)
    coarse = rng.choice(
        heights_range,
        (terrain.width // ds + 2, terrain.length // ds + 2),
    ).astype(np.float64)

    # bilinear upsample
    x = np.linspace(0, coarse.shape[0] - 1, terrain.width)
    y = np.linspace(0, coarse.shape[1] - 1, terrain.length)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, coarse.shape[0] - 1)
    y1 = np.minimum(y0 + 1, coarse.shape[1] - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[None, :]
    up = (
        coarse[np.ix_(x0, y0)] * (1 - fx) * (1 - fy)
        + coarse[np.ix_(x1, y0)] * fx * (1 - fy)
        + coarse[np.ix_(x0, y1)] * (1 - fx) * fy
        + coarse[np.ix_(x1, y1)] * fx * fy
    )
    terrain.height_field_raw += up.astype(np.int16)
    return terrain


def sloped_terrain(terrain: SubTerrain, slope: float = 1.0) -> SubTerrain:
    """Constant slope along x."""
    x = np.arange(terrain.width)
    max_h = int(slope * terrain.horizontal_scale / terrain.vertical_scale * terrain.width)
    hs = (max_h * x / terrain.width).astype(np.int16)
    terrain.height_field_raw += hs[:, None]
    return terrain


def pyramid_sloped_terrain(
    terrain: SubTerrain, slope: float = 1.0, platform_size: float = 1.0
) -> SubTerrain:
    """Pyramid with apex (or pit) at the center and a flat central platform."""
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width // 2, terrain.length // 2
    # normalized distance from edge toward center, per axis
    xx = (cx - np.abs(cx - x)) / cx
    yy = (cy - np.abs(cy - y)) / cy
    max_h = int(slope * terrain.horizontal_scale / terrain.vertical_scale * cx)
    hf = (max_h * np.minimum(xx[:, None], yy[None, :]))
    # flat platform at the center
    ps = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = cx - ps, cx + ps
    y1, y2 = cy - ps, cy + ps
    min_h = min(hf[x1, y1], 0)
    max_hp = max(hf[x1, y1], 0)
    hf[x1:x2, y1:y2] = np.clip(hf[x1:x2, y1:y2], min_h, max_hp)
    terrain.height_field_raw += hf.astype(np.int16)
    return terrain


def pyramid_stairs_terrain(
    terrain: SubTerrain,
    step_width: float,
    step_height: float,
    platform_size: float = 1.0,
) -> SubTerrain:
    """Concentric rectangular stairs toward the center."""
    sw = max(int(step_width / terrain.horizontal_scale), 1)
    sh = int(step_height / terrain.vertical_scale)
    ps = max(int(platform_size / terrain.horizontal_scale), 1)
    hf = terrain.height_field_raw
    height = 0
    x1, x2 = 0, terrain.width
    y1, y2 = 0, terrain.length
    while (x2 - x1) > ps and (y2 - y1) > ps:
        x1 += sw
        x2 -= sw
        y1 += sw
        y2 -= sw
        height += sh
        hf[x1:x2, y1:y2] = height
    return terrain


def discrete_obstacles_terrain(
    terrain: SubTerrain,
    max_height: float,
    min_size: float,
    max_size: float,
    num_rects: int,
    platform_size: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> SubTerrain:
    """Random rectangular blocks at heights in +-max_height."""
    rng = rng or np.random.default_rng()
    mh = int(max_height / terrain.vertical_scale)
    mins = max(int(min_size / terrain.horizontal_scale), 1)
    maxs = max(int(max_size / terrain.horizontal_scale), mins + 1)
    heights = [-mh, -mh // 2, mh // 2, mh]
    for _ in range(num_rects):
        w = int(rng.integers(mins, maxs))
        l = int(rng.integers(mins, maxs))
        sx = int(rng.integers(0, max(terrain.width - w, 1)))
        sy = int(rng.integers(0, max(terrain.length - l, 1)))
        terrain.height_field_raw[sx : sx + w, sy : sy + l] = int(rng.choice(heights))
    # flat central platform
    cx, cy = terrain.width // 2, terrain.length // 2
    ps = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - ps : cx + ps, cy - ps : cy + ps] = 0
    return terrain


def stepping_stones_terrain(
    terrain: SubTerrain,
    stone_size: float,
    stone_distance: float,
    max_height: float,
    platform_size: float = 1.0,
    depth: float = -10.0,
    rng: Optional[np.random.Generator] = None,
) -> SubTerrain:
    """Grid of stones with gaps of `depth` between them."""
    rng = rng or np.random.default_rng()
    ss = max(int(stone_size / terrain.horizontal_scale), 1)
    sd = max(int(stone_distance / terrain.horizontal_scale), 1)
    mh = int(max_height / terrain.vertical_scale)
    dep = int(depth / terrain.vertical_scale)
    hf = terrain.height_field_raw
    hf[:, :] = dep
    y = 0
    while y < terrain.length:
        x = int(rng.integers(0, ss + sd))  # random row offset
        # first partial stone
        hf[0 : max(0, x - sd), y : y + ss] = int(rng.integers(-mh, mh + 1)) if mh > 0 else 0
        while x < terrain.width:
            x2 = min(x + ss, terrain.width)
            y2 = min(y + ss, terrain.length)
            hf[x:x2, y:y2] = int(rng.integers(-mh, mh + 1)) if mh > 0 else 0
            x += ss + sd
        y += ss + sd
    cx, cy = terrain.width // 2, terrain.length // 2
    ps = int(platform_size / terrain.horizontal_scale / 2)
    hf[cx - ps : cx + ps, cy - ps : cy + ps] = 0
    return terrain


class TerrainGrid:
    """The task-level terrain composer (ref Terrain class,
    anymal_terrain.py:543-673): (num_levels x num_terrains) sub-terrain grid
    with curriculum difficulties, borders, and per-cell env origins."""

    def __init__(self, cfg: dict, num_robots: int, seed: int = 0):
        self.type = cfg["terrainType"]
        self.rng = np.random.default_rng(seed)
        if self.type in ("none", "plane"):
            self.env_origins = np.zeros((1, 1, 3))
            self.heightsamples = None
            return
        self.horizontal_scale = 0.1
        self.vertical_scale = 0.005
        self.border_size = 20.0
        self.env_length = cfg["mapLength"]
        self.env_width = cfg["mapWidth"]
        props = cfg["terrainProportions"]
        self.proportions = [sum(props[: i + 1]) for i in range(len(props))]

        self.env_rows = cfg["numLevels"]
        self.env_cols = cfg["numTerrains"]
        self.num_maps = self.env_rows * self.env_cols
        self.env_origins = np.zeros((self.env_rows, self.env_cols, 3))

        self.width_per_env_pixels = int(self.env_width / self.horizontal_scale)
        self.length_per_env_pixels = int(self.env_length / self.horizontal_scale)
        self.border = int(self.border_size / self.horizontal_scale)
        self.tot_cols = int(self.env_cols * self.width_per_env_pixels) + 2 * self.border
        self.tot_rows = int(self.env_rows * self.length_per_env_pixels) + 2 * self.border

        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols), dtype=np.int16)
        if cfg.get("curriculum", True):
            self._curriculum()
        else:
            self._randomized()
        self.heightsamples = self.height_field_raw

    def _sub(self):
        return SubTerrain(
            width=self.length_per_env_pixels,
            length=self.width_per_env_pixels,
            vertical_scale=self.vertical_scale,
            horizontal_scale=self.horizontal_scale,
        )

    def _paste(self, terrain, i, j):
        sx = self.border + i * self.length_per_env_pixels
        ex = sx + self.length_per_env_pixels
        sy = self.border + j * self.width_per_env_pixels
        ey = sy + self.width_per_env_pixels
        self.height_field_raw[sx:ex, sy:ey] = terrain.height_field_raw
        env_origin_x = (i + 0.5) * self.env_length
        env_origin_y = (j + 0.5) * self.env_width
        x1 = int((self.env_length / 2.0 - 1) / self.horizontal_scale)
        x2 = int((self.env_length / 2.0 + 1) / self.horizontal_scale)
        y1 = int((self.env_width / 2.0 - 1) / self.horizontal_scale)
        y2 = int((self.env_width / 2.0 + 1) / self.horizontal_scale)
        env_origin_z = np.max(terrain.height_field_raw[x1:x2, y1:y2]) * self.vertical_scale
        self.env_origins[i, j] = [env_origin_x, env_origin_y, env_origin_z]

    def _curriculum(self):
        for j in range(self.env_cols):
            for i in range(self.env_rows):
                terrain = self._sub()
                difficulty = i / self.env_rows
                choice = j / self.env_cols

                slope = difficulty * 0.4
                step_height = 0.05 + 0.175 * difficulty
                obstacle_height = 0.025 + difficulty * 0.15
                stone_size = 2 - 1.8 * difficulty
                p = self.proportions
                if choice < p[0]:
                    if choice < 0.05:
                        slope *= -1
                    pyramid_sloped_terrain(terrain, slope=slope, platform_size=3.0)
                elif choice < p[1]:
                    if choice < 0.15:
                        slope *= -1
                    pyramid_sloped_terrain(terrain, slope=slope, platform_size=3.0)
                    random_uniform_terrain(
                        terrain, -0.1, 0.1, step=0.025, downsampled_scale=0.2, rng=self.rng
                    )
                elif choice < p[3]:
                    if choice < p[2]:
                        step_height *= -1
                    pyramid_stairs_terrain(
                        terrain, step_width=0.31, step_height=step_height, platform_size=3.0
                    )
                elif choice < p[4]:
                    discrete_obstacles_terrain(
                        terrain, obstacle_height, 1.0, 2.0, 40, platform_size=3.0, rng=self.rng
                    )
                else:
                    stepping_stones_terrain(
                        terrain,
                        stone_size=stone_size,
                        stone_distance=0.1,
                        max_height=0.0,
                        platform_size=3.0,
                        rng=self.rng,
                    )
                self._paste(terrain, i, j)

    def _randomized(self):
        for k in range(self.num_maps):
            i, j = np.unravel_index(k, (self.env_rows, self.env_cols))
            terrain = self._sub()
            choice = self.rng.uniform(0, 1)
            if choice < 0.1:
                pyramid_sloped_terrain(
                    terrain, float(self.rng.choice([-0.3, -0.2, 0, 0.2, 0.3]))
                )
                if self.rng.choice([0, 1]):
                    random_uniform_terrain(
                        terrain, -0.1, 0.1, step=0.05, downsampled_scale=0.2, rng=self.rng
                    )
            elif choice < 0.6:
                step_height = float(self.rng.choice([-0.15, 0.15]))
                pyramid_stairs_terrain(
                    terrain, step_width=0.31, step_height=step_height, platform_size=3.0
                )
            else:
                discrete_obstacles_terrain(
                    terrain, 0.15, 1.0, 2.0, 40, platform_size=3.0, rng=self.rng
                )
            self._paste(terrain, int(i), int(j))
