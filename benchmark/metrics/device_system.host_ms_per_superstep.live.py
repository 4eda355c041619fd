"""device_system.host_ms_per_superstep.live: ``DeviceSystem``'s host work a
superstep: (Σ ``add_image`` spans − Σ ``DeviceVO.run_chunk`` spans) /
supersteps, the traced slice left out."""


def read(run):
    if run.system != "device_system" or run.supersteps <= 0 or run.add_image_s <= 0:
        return None
    return 1e3 * (run.add_image_s - run.run_chunk_s) / run.supersteps
