"""device_system.host_ms_per_frame: ``DeviceSystem``'s host work a frame:
(Σ ``add_image`` spans − Σ ``DeviceVO.run_chunk`` spans, each ended by a
synchronize) / frames, the traced slice left out."""


def read(run):
    if run.system != "device_system" or run.frames <= 0 or run.add_image_s <= 0:
        return None
    return 1e3 * (run.add_image_s - run.run_chunk_s) / run.frames
