"""Operations and bytes of the model's work, from shapes alone.

The dynamics model is an MLP ``[s; a] -> hidden -> hidden -> s'`` with two
ReLU hidden layers. A forward of one row costs 2 x its multiply-adds.
"""

from __future__ import annotations


def macs(sd: int, ad: int, hidden: int) -> int:
    """Multiply-adds of one forward of one row."""
    return (sd + ad) * hidden + hidden * hidden + hidden * sd


def forward_flops(sd: int, ad: int, hidden: int) -> int:
    return 2 * macs(sd, ad, hidden)


def sampler_flops(B: int, K: int, H: int, sd: int, ad: int,
                  hidden: int) -> int:
    """One launch of the candidate sampler: B x K candidates rolled H
    steps through the MLP."""
    return B * K * H * forward_flops(sd, ad, hidden)


def sampler_bytes(B: int, K: int, H: int, sd: int, ad: int, hidden: int,
                  word: int = 4) -> int:
    """One launch, each input read once and each output written once: the
    start states (B, sd), the proposal mean and std (B, H, ad) each, the
    weights and biases, the goal and cost weights (sd each); the costs
    (B, K) and the candidate actions (B, H, ad, K)."""
    weights = macs(sd, ad, hidden) + 2 * hidden + sd
    inputs = B * sd + 2 * B * H * ad + weights + 2 * sd
    outputs = B * K + B * H * ad * K
    return word * (inputs + outputs)


def plan_flops(B: int, K: int, H: int, cem_iters: int, sd: int, ad: int,
               hidden: int) -> int:
    """The model FLOP of one batched CEM plan: one sampler launch an
    iteration."""
    return cem_iters * sampler_flops(B, K, H, sd, ad, hidden)

