"""Steps replayed after every lane of a round had finished (the engine's
idle_steps), as a share of the steps replayed in the window: a count."""


def read(rec):
    steps = rec.counters.get("replayed_steps")
    if not steps:
        return None
    return 100.0 * rec.counters["idle_steps"] / steps
