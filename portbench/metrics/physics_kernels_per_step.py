"""Device kernels a control step's ``env.step`` runs: those launched inside
the traced units' ``physics`` spans (linked to their launch on the host by
the trace), copies and fills left out, over the traced steps."""

UNIT = 'kernels'


def read(ctx):
    trace = ctx['trace']
    n = len([s for s in (trace.spans if trace else ()) if s[0] ==
             'physics'])
    if not n:
        return None
    return len(trace.kernels(trace.ops_in('physics'))) / n
