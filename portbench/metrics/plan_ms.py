"""Mean ms of the batched CEM plan a control step: host clock around each
plan call, with a synchronize before and after (the traced run's
``plan`` spans)."""

UNIT = 'ms'


def read(ctx):
    spans = ctx['spans'].get('plan')
    return 1e3 * sum(spans) / len(spans) if spans else None
