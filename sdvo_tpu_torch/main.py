"""Command-line entry point of the port — the counterpart of ``sdvo_tpu.main``.

Reads a JSON config (default ``config/config.json``), configures logging,
loads the camera intrinsics from the OpenCV-YAML file the config names, lists
and sorts the image folder, then loops: decode grayscale → ``add_image``.
Writes KITTI-format poses (``out.txt``) and per-frame metrics
(``metrics.jsonl``) at the end.

The frame loop runs through the device-resident ``DeviceSystem``;
``--host-system`` selects the per-frame host ``System``. Both run on the CUDA
card and refuse to start without one; ``--cpu`` asks for the CPU (the
kernels' plain versions). ``--f64`` computes in float64 on either path (the
kernels compute in float32 inside and hand back float64).

The host path logs its stage timers (``System.timers``, spans of the port's
tracer ``utils.timing.TRACER``, which it turns on). On the device path
``-v`` turns the tracer on and logs the same report over every span: the
buffering, each dispatch's stack, copy in, graph replay and emission, the
bootstrap, and the graphs' warm-ups.

Usage:  python -m sdvo_tpu_torch.main [config.json] [--images DIR] [--output DIR]
        [--max-frames N] [--cpu] [--host-system] [--euroc SEQ_DIR] [--chunk N]
        [--f64] [-v]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="semi-direct visual odometry, PyTorch/CUDA port")
    parser.add_argument("config", nargs="?", default="config/config.json")
    parser.add_argument("--images", default=None, help="override image_data_path")
    parser.add_argument("--output", default=None, help="override output dir")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA card")
    parser.add_argument("--host-system", action="store_true",
                        help="per-frame host System instead of the device-resident path")
    parser.add_argument("--euroc", default=None, metavar="SEQ_DIR",
                        help="EuRoC ASL sequence dir (mav0): reads images + sensor.yaml")
    parser.add_argument("--chunk", type=int, default=8,
                        help="supersteps per device dispatch (device path)")
    parser.add_argument("--f64", action="store_true", help="float64 compute")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from sdvo_tpu_torch.config import load_config
    from sdvo_tpu_torch.dataio.datasets import (
        list_image_files, load_camera_yaml, load_euroc_sequence, load_image_grayscale,
    )
    from sdvo_tpu_torch.geometry.camera import PinholeCamera
    from sdvo_tpu_torch.pipeline.device_system import DeviceSystem
    from sdvo_tpu_torch.pipeline.system import FrameResult, System
    from sdvo_tpu_torch.utils.logging import configure_logging, get_logger, write_metrics_jsonl
    from sdvo_tpu_torch.utils.timing import TRACER

    configure_logging(level=logging.DEBUG if args.verbose else logging.INFO)
    log = get_logger("Main")

    dtype = torch.float64 if args.f64 else torch.float32
    overrides = None
    stamps = None
    if args.euroc:
        files, stamps, ecalib = load_euroc_sequence(args.euroc)
        K = ecalib["K"]
        camera = PinholeCamera.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], ecalib["width"],
                                      ecalib["height"], dist=ecalib["dist"], dtype=dtype)
        overrides = {"camera": {"img_width": ecalib["width"], "img_height": ecalib["height"]}}
        log.info("EuRoC camera: fx=%.3f cx=%.3f cy=%.3f", K[0, 0], K[0, 2], K[1, 2])
    config = load_config(args.config, overrides=overrides)
    if args.f64:
        config = config.replace(compute_dtype="float64")
    image_dir = args.images or config.file_paths.image_data_path
    out_dir = args.output or config.file_paths.output_dir
    os.makedirs(out_dir, exist_ok=True)
    if not args.euroc:
        calib = config.file_paths.camera_calibration_file
        if calib and os.path.exists(calib):
            K, d = load_camera_yaml(calib)
            camera = PinholeCamera.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], config.camera.img_width,
                                          config.camera.img_height, dist=d, dtype=dtype)
            log.info("camera: fx=%.3f cx=%.3f cy=%.3f", K[0, 0], K[0, 2], K[1, 2])
        else:
            camera = None
            log.warning("no calibration file at %s — using KITTI defaults", calib)
        files = list_image_files(image_dir)

    if args.max_frames:
        files = files[: args.max_frames]

    device = "cpu" if args.cpu else None  # None: the card, or an error where there is none
    with TRACER.recording(args.host_system or args.verbose):
        if args.host_system:
            system = System(config, camera=camera, device=device)
        else:
            system = DeviceSystem(config, camera=camera, supersteps_per_chunk=args.chunk, device=device)
        log.info("processing %d frames from %s [%s on %s]", len(files), args.euroc or image_dir,
                 type(system).__name__, system.device)

        t0 = time.perf_counter()
        for i, path in enumerate(files):
            img = load_image_grayscale(path)
            ts = float(stamps[i]) if stamps is not None else float(i)
            result = system.add_image(img, ts)
            if result == FrameResult.FAILED:
                log.warning("frame %d (%s): FAILED", i, os.path.basename(path))
            elif args.verbose and result is not None:
                log.debug("frame %d: %s", i, result.name)
        if isinstance(system, DeviceSystem):
            system.finish()
        wall = time.perf_counter() - t0

        pose_path = os.path.join(out_dir, "out.txt")
        system.write_poses(pose_path)
        write_metrics_jsonl(os.path.join(out_dir, "metrics.jsonl"), system.metrics)
        log.info("done: %d frames in %.1fs (%.1f fps) → %s", len(files), wall,
                 len(files) / max(wall, 1e-9), pose_path)
        if isinstance(system, System):
            log.info("timers:\n%s", system.timers.report())
            print(system.report_summary())
        else:
            if args.verbose:
                log.info("timers:\n%s", TRACER.report())
            ok = sum(1 for m in system.metrics if m.get("result") != "FAILED")
            print(f"DeviceSystem: {ok}/{len(system.metrics)} frames tracked, "
                  f"{system.n_relocalizations} relocalizations")
        return 0


if __name__ == "__main__":
    sys.exit(main())
