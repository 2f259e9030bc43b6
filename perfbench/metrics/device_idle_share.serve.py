"""The share of the serve cell's traced seconds in which no operation ran
on the card: 1 - busy / window, busy being the profiler's device time plus
the hand-written kernels' event-timed time, in percent."""


def read(record):
    if not record.get("window_s") or "busy_s" not in record:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
