"""device_idle_share: 100 minus the share of the profiled span in which
any device activity (kernel, copy or memset) ran."""


def read(obs):
    if obs is None or obs.span_s <= 0 or not obs.device:
        return None
    return 100.0 * (1.0 - obs.busy_s / obs.span_s)
