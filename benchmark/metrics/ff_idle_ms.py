"""ff_idle_ms: card idle ms a render inside the span radiosity.form_factors
(engines/radiosity.form_factors: every wall's chunks of rays, drawn and
cast), averaged over the cards, from the traced requests."""
from benchmark import spans


def read(run):
    return spans.card_idle_ms(run, "radiosity.form_factors")
