"""Mean ms of ``env.step`` a control step: host clock around each call,
with a synchronize before and after (the traced run's ``physics``
spans)."""

UNIT = 'ms'


def read(ctx):
    spans = ctx['spans'].get('physics')
    return 1e3 * sum(spans) / len(spans) if spans else None
