"""The share of the race kernels' issued car slots that carry a car, over
the window's launches: 100 x the growth of the program's `race.cars` over
that of `race.slots` (the server's `/stats` `kernels`, read before the
window and after its last request). 22 cars on one simulation a warp read
22 / 32 = 68.75%. Nothing is read where the program serves no such
counters, or launched no kernel."""


def read(run):
    k = run.work.get("kernels")
    if not k or not k.get("slots"):
        return None
    return 100.0 * k["cars"] / k["slots"]
