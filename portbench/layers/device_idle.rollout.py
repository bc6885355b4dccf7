"""The device's idle share of a unit, in percent: one minus the device's
busy time a unit in the traced stretch (the union of its operations) over
the untraced window's time a unit.  The traced stretch's own length is not
the denominator: the profiler slows the host 1.5 to 2.5 times, so its idle
share would mostly measure the profiler."""


def read(traced):
    if not traced.busy_s or not traced.units or not getattr(traced, "unit_s", None):
        return None
    return 100.0 * (1.0 - traced.busy_s / traced.units / traced.unit_s)
