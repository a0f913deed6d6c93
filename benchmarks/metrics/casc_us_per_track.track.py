"""The cascade's cost per held track, in us: the tracker's ms per frame
(``PipelinedRunner.timings()['casc_track']``) over the tracks it held per
frame (``n.tracks_held``: tracked and lost after each update) over the
window; the seed moves the held tracks, and with them ``cascade_ms``, more
than this."""


def read(run):
    t = run.window["timings"]
    held = t.get("n.tracks_held")
    if "casc_track" not in t or not held:
        return None
    return 1000.0 * t["casc_track"] / held
