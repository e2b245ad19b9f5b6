"""transfer_share: device time of host-to-device and device-to-host
copies over the profiled span."""

H2D_D2H = r"^Memcpy (HtoD|DtoH)"


def read(obs):
    if obs is None or obs.span_s <= 0:
        return None
    t = obs.seconds(H2D_D2H, kinds=("memcpy",))
    if t <= 0:
        return None
    return 100.0 * t / obs.span_s
