"""Lanes of the blind rounds' chunks that held a frame (%): the endpoint's
live frame-rounds (frames decoded, a frame once a round) over its lanes
dispatched (chunks times lanes), both counted over the window's blocks."""


def read(run):
    units = [u for u in run.units if u.get("lanes_dispatched")]
    if not units:
        return None
    return 100.0 * sum(u["live_frame_rounds"] for u in units) / sum(
        u["lanes_dispatched"] for u in units)
