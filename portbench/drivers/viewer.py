"""The web viewer's present loop (the port's ``cli/webview.py``, as
``tools/interactive.py`` runs it), closed loop: before each frame an
optional camera turn (``turn`` radians about the camera's local y axis:
the viewer's 'j' key turns 0.02), then
``step_nosync(spp_per_frame)``, ``image_u8()`` (which drains the
carried-over pool) and the pinned, non-blocking copy to the host
(``_HostFrame``); frame N+1 is dispatched before frame N is read.

Traffic parameters: ``renderer`` ("full", or "preview": ``web``'s
reduced renderer), ``turn``, ``spp_per_frame`` and ``check``.
With a still camera every frame adds to one accumulation, which starts
clean at the window's start, and the check takes ``pixels`` pixels of
every presented frame and of the final radiance, fewer where the
reference would trace more than ``paths`` paths.  With a moving camera
every frame restarts, and the check takes ``frame_pixels`` pixels of
every frame and ``radiance_pixels`` of the last frame's radiance."""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers.common import Driver, HostSeeds, rot

# Pixel sets drawn per frame before the window; frames beyond reuse them.
FRAME_SETS = 4096
# The camera's local y: the viewer's turn keys 'j' and 'l'.
AXIS = 1


class Viewer(Driver):

    def build(self):
        t = self.traffic
        self.r = self.cell.renderer(t.get("renderer", "full"))
        self.host = HostSeeds(self.cell.host_seed)
        self.turn = float(t.get("turn", 0.0))
        self.spp = int(t.get("spp_per_frame", 1))
        chk = t["check"]
        h, w = self.r.config.render_height, self.r.config.render_width
        rng = self.cell.rng("pixels")
        if self.turn:
            self.frame_px = list(rng.integers(
                0, [w, h], (FRAME_SETS, int(chk["frame_pixels"]), 2)))
            self.rad_px = rng.integers(0, [w, h],
                                       (int(chk["radiance_pixels"]), 2))
        else:
            px = rng.integers(0, [w, h], (int(chk["pixels"]), 2))
            self.frame_px = [px]
            self.rad_px = px
        self.cam = self.cell.camera.copy()
        self.acc = None

    def _submit(self, record: bool):
        """Dispatch one frame; returns (the frame on its way to the host,
        its accumulation, the samples it shows)."""
        from logipathtracer_tpu_torch.cli.webview import _HostFrame
        r, sp, c = self.r, self.cell.spans, self.count
        restart = self.acc is None or bool(self.turn)
        if self.turn:
            r.rotate(AXIS, self.turn)
            self.cam = (self.cam @ rot(AXIS, self.turn)).astype(np.float32)
        if restart:
            self.acc = self.new_accumulation(self.cam, keep=record)
        rays0 = 0.0 if restart else r.total_rays
        with sp("step"):
            r.step_nosync(self.spp)
        self.acc.seeds.append(self.host.draw(self.spp))
        c["iterations"] += r.last_iterations
        c["rays"] += r.total_rays - rays0
        rays1 = r.total_rays
        with sp("present"):
            frame = _HostFrame(r.image_u8())
        c["iterations"] += r.last_iterations
        c["rays"] += r.total_rays - rays1
        return frame, self.acc, self.acc.samples

    def _read(self, pending, index):
        frame, acc, k = pending
        with self.cell.spans("copy"):
            rgba = frame.numpy()
        if index is not None:
            acc.add_frame(k, self.frame_px[index % len(self.frame_px)], rgba)

    def warm_up(self):
        self._read(self._submit(record=False), None)
        # The measured accumulation starts clean, as after a camera move.
        self.r.reset()
        self.acc = None

    def window(self, seconds: float):
        cell, c = self.cell, self.count
        t_start = cell.clock.start()
        deadline = t_start + seconds
        pending = self._submit(record=True)
        i = 0
        while True:
            nxt = (self._submit(record=True)
                   if time.perf_counter() < deadline else None)
            self._read(pending, i)
            cell.clock.present()
            c["frames"] += 1
            c["samples"] += self.spp
            i += 1
            if nxt is None:
                break
            pending = nxt
        cell.clock.stop()
        c["attempted"] += i

    def finish(self):
        """After the window: the program's radiance of the last
        accumulation at its checked pixels."""
        self.accs[-1].set_radiance(self.rad_px, self.r.radiance())
        limit = self.traffic["check"].get("paths")
        if not self.turn and limit:
            # Fewer pixels where the accumulation is long.
            keep = max(16, int(limit) // max(self.accs[-1].samples, 1))
            self.accs[-1].trim_pixels(keep)


DRIVER = Viewer
