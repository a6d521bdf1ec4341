"""Still renders back to back as ``render.py`` makes them, each a single
shot: the renderer is built with ``pool_carryover`` from the traffic
(false), so every ``step(spp)`` is one ``render_wavefront`` call whose
paths all end inside it, and ``image_u8()`` has no pool to drain.  The
host seeds are drawn as before (``(spp, 2)`` a step either way)."""

from __future__ import annotations

from portbench.drivers.render import Render


class RenderSingleShot(Render):

    def build(self):
        self.cell.config["render"]["pool_carryover"] = bool(
            self.traffic["pool_carryover"])
        super().build()

    def _render(self, index):
        super()._render(index)
        # The present drained nothing, so its iterations are the step's,
        # which ``Render._render`` has counted already.
        self.count["iterations"] -= self.r.last_iterations


DRIVER = RenderSingleShot
