"""Share of the profiled slice in which no operation ran on the device
(one less the union of the device's operation intervals over the slice),
in percent."""


def read(r):
    s = r["slice"]
    if not s.get("n_device_ops"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
