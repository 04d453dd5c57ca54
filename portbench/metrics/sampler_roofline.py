"""The candidate sampler kernel's share of its roofline: the least time
of its launches (the larger of the MLP's FLOP over the TF32 peak, the
peak of the float32 the configuration states, and its bytes, each read
or written once, over the HBM's bandwidth) over their device time in the
trace, matched by the kernel's name."""

from counts import mlp, peaks

UNIT = '%'
KERNEL = 'cem_sample_rollout_kernel'


def read(ctx):
    trace = ctx['trace']
    if trace is None:
        return None
    seconds, launches = trace.kernel_seconds(KERNEL)
    if not launches:
        return None
    cell, P = ctx['cell'], ctx['cfg']['planner']
    hidden = ctx['cfg']['model']['hidden']
    shape = (cell.B, P['candidates'], P['horizon'], cell.sd, cell.ad,
             hidden)
    least = max(mlp.sampler_flops(*shape)
                / peaks.PEAK_FLOPS[ctx['cfg']['precision']],
                mlp.sampler_bytes(*shape) / peaks.PEAK_BYTES_PER_S)
    return 100.0 * launches * least / seconds
