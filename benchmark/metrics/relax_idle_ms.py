"""relax_idle_ms: card idle ms a render inside the span radiosity.relax
(engines/radiosity.relax: the iterations' gathers and combines), averaged
over the cards, from the traced requests."""
from benchmark import spans


def read(run):
    return spans.card_idle_ms(run, "radiosity.relax")
