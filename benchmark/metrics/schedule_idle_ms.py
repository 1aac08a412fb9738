"""schedule_idle_ms: card idle ms a render inside the span photon.schedule
(engines/schedule.run_schedule, the photon batch loop): the launch gaps of
its 11,742 batches, from the traced requests."""
from benchmark import spans


def read(run):
    return spans.card_idle_ms(run, "photon.schedule")
