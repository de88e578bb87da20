"""inputs_idle_ms: device-idle ms a step charged to the program's
`fps.step_inputs` range (`spans.idle_by_span`: each idle gap goes to the
innermost range window holding the device event that ends it), that is
the card waiting while the host samples the next step's cameras, ladder,
augmentations and draws; from the traced steps."""

from benchmark import spans

SPAN = "fps.step_inputs"


def read(ctx):
    tr = ctx.trace
    if tr is None or SPAN not in tr.ranges:
        return None
    return dict(spans.idle_by_span(tr)).get(SPAN, 0.0) * 1e3 / tr.n_steps
