"""The comparison that decides ``correct``: the plain reference traces
every checked path again, from the benchmark's own scene description
and the inputs the drivers recorded (camera, host seeds, pixels), and
its answers are held to the program's:

  radiance_bad  the share of checked pixels whose mean radiance misses
                the repository's pixel rule against the reference's
                (|a - b| <= 1e-6 + 1e-4 |b| in every channel,
                tests/test_wavefront.py:36-37);
  frame_bad     the share of checked pixels of the presented frames
                whose RGBA differs from the reference's display
                transform of its own sums by more than one level.

``control`` puts the reference itself, computed in a lower precision,
in the program's place."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.refs import pathtrace as ref

ATOL, RTOL = 1e-6, 1e-4
LEVELS = 1


def _paths(accs):
    """The flat path list of every (accumulation, pixel set) to its
    deepest checked sample: cams [N, 4, 4], ubo [N, 2], pix [N, 2], and
    the (accumulation, pixel set, samples, pixels) of each group."""
    need = {}
    for a, acc in enumerate(accs):
        for k, i, _ in acc.frames:
            need[(a, i)] = max(need.get((a, i), 0), k)
        if acc.radiance is not None:
            k, i, _ = acc.radiance
            need[(a, i)] = max(need.get((a, i), 0), k)
    cams, ubo, pix, groups = [], [], [], []
    for (a, i), k in sorted(need.items()):
        acc = accs[a]
        seeds = np.concatenate(acc.seeds)[:k]
        px = np.asarray(acc.pixsets[i], np.int64)
        p = px.shape[0]
        ubo.append(np.repeat(seeds, p, axis=0))
        pix.append(np.tile(px, (k, 1)))
        cams.append(np.broadcast_to(acc.cam, (k * p, 4, 4)))
        groups.append((a, i, k, p))
    return (np.concatenate(cams), np.concatenate(ubo), np.concatenate(pix),
            groups)


def reference_sums(scene, render, accs, device, dtype=torch.float32):
    """{(accumulation, pixel set): running radiance sums [k, P, 3]
    float32 numpy}, added sample by sample in float32, of the samples a
    ``dtype`` reference traced on ``device``."""
    cams, ubo, pix, groups = _paths(accs)
    rs = ref.RefScene(scene, device, dtype)
    fov = accs[0].fov
    v = ref.trace(rs, render, torch.from_numpy(np.ascontiguousarray(cams)),
                  fov, torch.from_numpy(ubo), torch.from_numpy(pix))
    v = v.to(torch.float32).cpu().numpy()
    out = {}
    at = 0
    for a, i, k, p in groups:
        # add.accumulate runs sample by sample in float32
        out[(a, i)] = np.cumsum(v[at:at + k * p].reshape(k, p, 3), axis=0,
                                dtype=np.float32)
        at += k * p
    return out


def answers(accs, sums, render):
    """What the reference (from ``sums``) presents and accumulates where
    the program's answers were taken: ([frame RGBA [P, 4]], [mean
    radiance [P, 3]]) in the order of ``program_answers``."""
    frames, rad = [], []
    for a, acc in enumerate(accs):
        for k, i, _ in acc.frames:
            frames.append(ref.to_u8(torch.from_numpy(sums[(a, i)][k - 1]),
                                    k, render["exposure"],
                                    render["gamma"]).numpy())
        if acc.radiance is not None:
            k, i, _ = acc.radiance
            rad.append(sums[(a, i)][k - 1] / np.float32(k))
    return frames, rad


def program_answers(accs):
    frames = [u8 for acc in accs for _, _, u8 in acc.frames]
    rad = [acc.radiance[2] for acc in accs if acc.radiance is not None]
    return frames, rad


def compare(got, want) -> dict:
    """The two numbers compared, and how many answers each covers."""
    gf, gr = got
    wf, wr = want
    f_bad = f_n = r_bad = r_n = 0
    for g, w in zip(gf, wf):
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        f_bad += int((diff > LEVELS).any(axis=-1).sum())
        f_n += g.shape[0]
    for g, w in zip(gr, wr):
        ok = np.abs(g - w) <= ATOL + RTOL * np.abs(w)
        r_bad += int((~ok).any(axis=-1).sum())
        r_n += g.shape[0]
    return {"radiance_bad": r_bad / max(r_n, 1),
            "frame_bad": f_bad / max(f_n, 1),
            "radiance_pixels": r_n, "frame_pixels": f_n}


def run_check(scene, render, accs, device, control: bool = False) -> dict:
    """Compare the program's answers (or, with ``control``, a bfloat16
    reference's) with the float32 reference's."""
    t0 = time.perf_counter()
    sums = reference_sums(scene, render, accs, device)
    want = answers(accs, sums, render)
    if control:
        got = answers(accs, reference_sums(scene, render, accs, device,
                                           torch.bfloat16), render)
    else:
        got = program_answers(accs)
    out = compare(got, want)
    out["reference_s"] = time.perf_counter() - t0
    out["paths"] = int(sum(k * p for _, _, k, p in _paths(accs)[3]))
    return out
