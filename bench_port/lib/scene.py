"""A cell's scene from its files: the reference's :class:`Scene`, the
poses, the configuration's grid, and the program's plan and cameras."""

from __future__ import annotations

import time

from bench_port.reference import dense_grid as ref


def scene(config: dict, traffic: dict) -> ref.Scene:
    """The cell's scene. Its jitter is keyed on the traffic's fixed
    ``jitter_seed``, so that every run's seed gives the same schedule
    sizes; the run's seed orders the work instead (:func:`order`)."""
    return ref.Scene(width=int(traffic["width"]),
                     height=int(traffic["height"]),
                     focal=float(config["focal_scale"]) * traffic["width"],
                     t_near=float(config["t_near"]),
                     t_far=float(config["t_far"]),
                     n_steps=int(traffic["steps"]),
                     seed=int(traffic["jitter_seed"]),
                     bbox_min=tuple(config["bbox_min"]),
                     bbox_max=tuple(config["bbox_max"]))


def poses(traffic: dict) -> list:
    """The cell's camera poses: ``count`` of the ``of`` poses of its
    translation orbit, from the first."""
    orbit = traffic["orbit"]
    return [ref.orbit_c2w(i, int(orbit["of"]), float(orbit["amp_x"]),
                          float(orbit["amp_y"]), float(orbit["tz"]))
            for i in range(int(orbit["count"]))]


def order(n: int, seed: int) -> list:
    """A permutation of range(n) drawn from ``seed``."""
    keys = ref.jitter(seed, ref.torch.arange(n), ref.torch.tensor(0))
    return [int(i) for i in ref.torch.argsort(keys, stable=True)]


def grid(config: dict, device):
    """The configuration's (sigma, colour) grid, made on the device from
    its formula."""
    g = config["grid"]
    return ref.blob_grid(int(g["n"]), float(g["peak"]), float(g["width"]),
                         tuple(g["centre"]), device)


def plan(P, sc: ref.Scene, c2w):
    """The program's plan of the scene, with the pose ``c2w``."""
    w, h = sc.width, sc.height
    return P.Plan.create(P.PlanConfig(
        width=w, height=h, t_near=sc.t_near, t_far=sc.t_far, seed=sc.seed,
        camera=P.CameraConfig(k=(sc.focal, 0.0, w / 2, 0.0, sc.focal, h / 2,
                                 0.0, 0.0, 1.0), c2w=tuple(c2w)),
        sampling=P.SamplingConfig(dt=sc.dt, max_steps=sc.n_steps,
                                  mode=P.SamplingMode.STRATIFIED)))


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def settle(torch, device) -> None:
    """Free the inputs' scratch and start the program's memory peak."""
    sync(torch, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak(torch, device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(torch, device) -> None:
    """Release what the program held, before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def steady() -> None:
    """End set-up: collect, then freeze what set-up left (the imports'
    few hundred thousand objects), so that the collector's passes in the
    window scan only what the window makes. Unfrozen, a full pass over
    them stalled a frame by 65-176 ms one to three times a window."""
    import gc

    gc.collect()
    gc.freeze()


def clock() -> float:
    return time.perf_counter()
