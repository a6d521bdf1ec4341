"""What every traffic driver shares: the mirror of the renderer's host
seeds, the record of an accumulation (the inputs the reference needs and
the answers the program gave), and the camera turn."""

from __future__ import annotations

import numpy as np


def rot(axis: int, angle: float) -> np.ndarray:
    """The 4x4 rotation of a camera turn about its local ``axis`` (the
    viewer's keys, src/Main.cpp:57-93): the matrix a turn multiplies the
    camera's world matrix by on the right."""
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    if axis == 1:
        m[i, j] = s
        m[j, i] = -s
    else:
        m[i, j] = -s
        m[j, i] = s
    return m


class HostSeeds:
    """The host seed pairs a renderer built with ``host_seed`` draws:
    ``integers(1, 2**31, (n, 2))`` for every ``step(n)``, the
    reference's per-sample seed (src/RendererPT.cpp:584-585)."""

    def __init__(self, host_seed: int):
        self.rng = np.random.default_rng(host_seed)

    def draw(self, n: int) -> np.ndarray:
        return self.rng.integers(1, 2 ** 31, (n, 2), dtype=np.int64)


class Accumulation:
    """The samples since one reset: the camera, the field of view and the
    host seeds in order, the pixel sets checked, and the answers: frames
    (samples so far, pixel set, RGBA there) and the mean radiance
    (pixel set, [P, 3])."""

    def __init__(self, cam, fov: float):
        self.cam = np.asarray(cam, np.float32).copy()
        self.fov = float(fov)
        self.seeds = []
        self.pixsets = []
        self.frames = []
        self.radiance = None

    @property
    def samples(self) -> int:
        return sum(len(s) for s in self.seeds)

    def pixset(self, px) -> int:
        for i, p in enumerate(self.pixsets):
            if p is px:
                return i
        self.pixsets.append(px)
        return len(self.pixsets) - 1

    def add_frame(self, samples: int, px, rgba_u8):
        """The frame [H, W, 4] presented after ``samples`` samples, at
        pixels ``px`` [P, 2] (x, y counted from the bottom row; the
        display flips rows)."""
        h = rgba_u8.shape[0]
        self.frames.append((samples, self.pixset(px),
                            rgba_u8[h - 1 - px[:, 1], px[:, 0]].copy()))

    def trim_pixels(self, keep: int):
        """Check only the first ``keep`` pixels of every pixel set."""
        self.pixsets = [p[:keep] for p in self.pixsets]
        self.frames = [(k, i, v[:keep]) for k, i, v in self.frames]
        if self.radiance is not None:
            k, i, v = self.radiance
            self.radiance = (k, i, v[:keep])

    def set_radiance(self, px, radiance_mean):
        """The program's mean radiance [H, W, 3] at pixels ``px``."""
        self.radiance = (self.samples, self.pixset(px),
                         np.asarray(radiance_mean[px[:, 1], px[:, 0]],
                                    np.float32))


class Driver:
    """A traffic mix's driver: ``build`` the cell's renderer, ``warm_up``
    every shape the window uses, run the ``window``, ``finish`` by
    reading what the check needs, and keep in ``accs`` the accumulations
    whose answers the check compares.  Counts go to ``cell.count``, host
    spans to ``cell.spans``, presents to ``cell.clock``."""

    def __init__(self, cell, traffic: dict):
        self.cell = cell
        self.traffic = traffic
        self.accs = []

    @property
    def count(self) -> dict:
        return self.cell.count

    def new_accumulation(self, cam, keep: bool = True) -> Accumulation:
        """A new accumulation on ``cam``; ``keep``: the check compares
        it (the warm-up's is not)."""
        acc = Accumulation(cam, self.cell.fov)
        if keep:
            self.accs.append(acc)
        return acc
