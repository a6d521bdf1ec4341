"""Still renders back to back, closed loop, as the command line's
``render`` makes them (the port's ``cli/main.py`` ``cmd_render``): a
reset, ``step(spp)``, then ``image_u8()`` (which drains the pool)
copied to the host; no encode and no file.

Traffic parameters: ``spp`` and ``check``: ``renders`` renders are
checked, the last and others drawn from the seed, each at ``pixels``
pixels of its presented frame, and the last one's radiance there."""

from __future__ import annotations

import time

from portbench.drivers.common import Driver, HostSeeds

# Pixel sets drawn per render before the window; renders beyond reuse them.
RENDER_SETS = 256


class Render(Driver):

    def build(self):
        t = self.traffic
        self.r = self.cell.renderer("full")
        self.host = HostSeeds(self.cell.host_seed)
        self.spp = int(t["spp"])
        h, w = self.r.config.render_height, self.r.config.render_width
        n = int(t["check"]["pixels"])
        self.px = list(self.cell.rng("pixels").integers(
            0, [w, h], (RENDER_SETS, n, 2)))

    def _render(self, index):
        r, sp, c = self.r, self.cell.spans, self.count
        acc = self.new_accumulation(self.cell.camera,
                                     keep=index is not None)
        r.reset()
        with sp("step"):
            r.step(self.spp)
        acc.seeds.append(self.host.draw(self.spp))
        c["iterations"] += r.last_iterations
        c["rays"] += r.total_rays
        rays1 = r.total_rays
        with sp("present"):
            frame = r.image_u8()
        c["iterations"] += r.last_iterations
        c["rays"] += r.total_rays - rays1
        with sp("copy"):
            rgba = frame.cpu().numpy()
        if index is not None:
            acc.add_frame(acc.samples, self.px[index % len(self.px)], rgba)

    def warm_up(self):
        self._render(None)

    def window(self, seconds: float):
        cell, c = self.cell, self.count
        t_start = cell.clock.start()
        i = 0
        while True:
            self._render(i)
            cell.clock.present()
            c["frames"] += 1
            c["samples"] += self.spp
            i += 1
            if time.perf_counter() >= t_start + seconds:
                break
        cell.clock.stop()
        c["attempted"] += i

    def finish(self):
        """After the window: the last render's radiance at its checked
        pixels, and the renders the check takes: the last and
        ``renders - 1`` others drawn from the seed."""
        last = self.accs[-1]
        last.set_radiance(last.pixsets[0], self.r.radiance())
        want = int(self.traffic["check"]["renders"])
        others = self.accs[:-1]
        pick = self.cell.rng("renders").permutation(len(others))[:want - 1]
        self.accs = [others[i] for i in sorted(pick)] + [last]


DRIVER = Render
