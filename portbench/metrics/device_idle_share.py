"""Share of the profiled slice's wall in which no operation ran on the
device, in % (1 - union of device intervals / wall)."""


def read(run):
    p = run.profile
    if p is None or not p.device_ops or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
