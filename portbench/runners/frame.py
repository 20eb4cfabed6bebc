"""The frame runner: one viewer in a closed loop.  Frames go back to back
through the port's ``make_render_fn`` (one replayed CUDA graph a frame),
each the next of the orbit's views, each timed from the call until its
rgb is on the host.  Set-up makes the weights, refreshes the occupancy
map once from the seeded field (``refresh_occupancy``, as the demo does)
and renders ``warmup_frames`` frames, the capture in the first.

``render_rays_per_s`` is every pixel of every frame of the window over
all the window's time; ``frame_ms_p90`` the nearest-rank 90th percentile
of all its frames.  After the window, ``check_frames`` of its frames,
drawn from the seed, are held against the plain reference's frames of
the same views.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import checks, flops, profiling, stats
from portbench.program import make_render_fn, nerf_params, port_config, refresh_occupancy
from portbench.reference import frame as ref_frame
from portbench.reference import nerf as R
from portbench.scene import nerf_weights, orbit_views


def views(tr: dict, device):
    """(w2c poses [n, 3, 4], K [3, 3]) of the orbit, float32 on the device."""
    poses, K = orbit_views(tr["views"], tr["img_h"], tr["img_w"], tr["radius"], tr["elevation"])
    return (torch.as_tensor(poses, dtype=torch.float32, device=device),
            torch.as_tensor(K, dtype=torch.float32, device=device))


def reference_map(b, raw, prec: str = "fp32"):
    """The reference's own occupancy map of the seeded field, with the
    refresh's lattice jitter (the program's rule: a generator seeded from
    ``train.seed`` and epoch 0)."""
    if b.traffic["map"] != "refresh":
        return None
    nc = b.config["nerf"]
    g = nc["occ_grid_size"]
    st = np.random.SeedSequence([(b.config["train"]["seed"] ^ 0x0CC) & 0xFFFFFFFFFFFFFFFF, 0])
    seed = int(st.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF
    gen = torch.Generator(device=b.device).manual_seed(seed)
    jitter = torch.rand((g ** 3, 3), generator=gen, device=b.device)
    return R.occupancy_map(raw, nc, jitter, prec)


def run(b) -> dict:
    cfg, tr, dev = b.config, b.traffic, b.device
    h, w = tr["img_h"], tr["img_w"]
    raw = nerf_weights(cfg["nerf"], b.seed, dev)
    port_cfg = port_config(cfg)
    params = nerf_params(raw, port_cfg, dev)
    occ = refresh_occupancy(params, port_cfg, dev, 0) if tr["map"] == "refresh" else None
    render = make_render_fn(port_cfg, h, w, device=dev)
    poses, K = views(tr, dev)
    n_views = poses.shape[0]
    start = int(np.random.default_rng(b.seed).integers(n_views))
    frame_i = 0

    def frame():
        nonlocal frame_i
        rgb = render(params, poses[(start + frame_i) % n_views], K, occ)[0].cpu()
        frame_i += 1
        return rgb

    for _ in range(tr["warmup_frames"]):
        frame()
    b.sync()
    setup_s = time.time() - b.t0

    ms, kept, trace = [], [], None
    first = frame_i
    t0 = time.perf_counter()
    while True:
        if b.trace and trace is None and ms:
            box = []

            def profiled():
                for _ in range(tr["profile_frames"]):
                    t = time.perf_counter()
                    box.append((frame(), (time.perf_counter() - t) * 1e3))
            trace = profiling.record(profiled, b.sync)
            kept += [rgb for rgb, _ in box]
            ms += [m for _, m in box]
        else:
            t = time.perf_counter()
            kept.append(frame())
            ms.append((time.perf_counter() - t) * 1e3)
        if time.perf_counter() - t0 >= b.seconds and (not b.trace or trace is not None):
            break
    window_s = time.perf_counter() - t0
    pixels = h * w
    bad = sum(int(not torch.isfinite(x).all()) for x in kept)
    out = {"attempted": len(ms), "failed": bad, "setup_s": setup_s,
           "e2e": {"render_rays_per_s": stats.rate(len(ms) * pixels, window_s),
                   "frame_ms_p90": stats.percentile(ms, 90), "setup_s": setup_s},
           "frame_ms": ms}
    culled = occ is not None
    if trace is not None:
        s = profiling.summary(trace, b.layer_maps)
        s.update(kind="frame", units=tr["profile_frames"], world=1,
                 flops_per_unit=flops.frame_flops(cfg, pixels, culled),
                 bound_s_per_unit=flops.least_time(flops.frame_kernel_passes(cfg, pixels, culled)))
        out["trace"] = [s]
    out["peak"] = float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0.0

    pick = np.random.default_rng([b.seed & 0xFFFFFFFFFFFFFFFF, 5]).choice(
        len(kept), size=min(tr["check_frames"], len(kept)), replace=False)
    sample = [((start + first + int(i)) % n_views, kept[int(i)]) for i in pick]
    render.release()
    del render, params, occ, kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["readings"] = reference_readings(b, raw, sample, poses, K)
    return out


def render_views(b, raw, vs, poses, K, prec: str = "fp32"):
    """The reference's rgb of the views ``vs``, its map its own."""
    tr = b.traffic
    occ = reference_map(b, raw, prec)
    return [ref_frame.render(raw, b.config, poses[v], K, tr["img_h"], tr["img_w"], occ, prec)
            for v in vs]


def reference_frames(b, raw, sample, poses, K):
    """[(program rgb, reference rgb)] of the sampled (view, rgb) frames."""
    refs = render_views(b, raw, [v for v, _ in sample], poses, K)
    return [(rgb.to(b.device), r) for (_, rgb), r in zip(sample, refs)]


def reference_readings(b, raw, sample, poses, K) -> dict:
    return checks.frame_readings(reference_frames(b, raw, sample, poses, K))
