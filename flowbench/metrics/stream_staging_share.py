"""stream_staging_share: host seconds inside the streamed mode's staging,
``piecewise._Stager.put`` (a slab gathered into page-locked memory and its
copy enqueued) and ``_Stager.store`` (a result written into its host
array), each without the waits inside it, over the wall of the traced
run's unprofiled pairs (``system.host_split``)."""


def read(obs):
    if obs is None or obs.mode != "stream" or obs.staging_wall <= 0:
        return None
    s = obs.staging
    return 100.0 * (s.get("put", 0.0) + s.get("store", 0.0)) / obs.staging_wall
