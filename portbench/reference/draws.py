"""The law of the candidate sampler's draws, as the configuration states
it: K antithetic candidates around the proposal mean / std, triangular
noise z = (u1 + u2 - 1) sqrt(6) of unit variance on [-sqrt(6), sqrt(6)],
candidate k + ceil(K/2) the mirror of candidate k, each clipped to
[-1, 1]; every env, candidate and entry its own draw.

The checks read only what the sampler returned and the proposal it was
given, so that they judge the kernel's draws and not a draw of their own:

- ``draw_gap``: the largest of (|c| - 1)+ over all candidates, and of
  |c_k + c_{k+Kz} - 2 mean| over the pairs whose members both lie strictly
  inside (-1, 1) (clipped pairs are no mirror).
- ``noise_z``: for every such pair, z = (c_k - mean) / std. Both members
  are unclipped exactly when |z| < r = min((1 - |mean|) / std, sqrt(6)),
  so given that, |z| has the triangular law cut to [0, r], and
  u = (2 a |z| - z^2) / (2 a r - r^2), a = sqrt(6), is uniform on [0, 1)
  and sign(z) is +-1 with equal odds, whatever the proposal. Pooled over
  the window an env, the z-scores of mean(u) - 1/2 (sd sqrt(1 / 12 n))
  and of mean(sign z) (sd sqrt(1 / n)); the largest |z-score| over the
  checked envs.
- ``noise_repeat``: the share of pair entries whose z equals, within
  ``REPEAT_TOL``, the same entry of the next checked env, or of the next
  candidate of the same env; the larger of the two shares.
"""

from __future__ import annotations

import math

import torch

A = 6.0 ** 0.5
REPEAT_TOL = 1e-4


class DrawStats:
    """Accumulates the three readings over the recorded CEM iterations."""

    def __init__(self):
        self.gap = 0.0
        self.n = self.su = self.ss = None
        self.close = [0, 0]
        self.pairs = [0, 0]

    def add(self, mean, std, cands) -> None:
        """One iteration: proposal mean, std (E, H, ad), candidates
        (E, H, ad, K), as the sampler was given and returned them."""
        c = cands.double()
        m = mean.double()[..., None]
        s = std.double()[..., None]
        K = c.shape[-1]
        Kz = (K + 1) // 2
        lo, hi = c[..., :K - Kz], c[..., Kz:]
        valid = (lo.abs() < 1) & (hi.abs() < 1)
        self.gap = max(self.gap, float((c.abs() - 1).clamp(min=0).max()),
                       float(torch.where(valid, (lo + hi - 2 * m).abs(),
                                         0.0).max()))
        z = (lo - m) / s
        r = ((1 - m.abs()) / s).clamp(max=A)
        x = z.abs()
        den = torch.where(valid, 2 * A * r - r * r, 1.0)
        u = (2 * A * x - x * x) / den
        E = c.shape[0]
        n = valid.reshape(E, -1).sum(1).double()
        su = torch.where(valid, u - 0.5, 0.0).reshape(E, -1).sum(1)
        ss = torch.where(valid, torch.sign(z), 0.0).reshape(E, -1).sum(1)
        if self.n is None:
            self.n, self.su, self.ss = n, su, ss
        else:
            self.n, self.su, self.ss = self.n + n, self.su + su, self.ss + ss
        for j, dim in enumerate((0, -1)):
            if z.shape[dim] < 2:
                continue
            both = valid & valid.roll(1, dim)
            near = both & ((z - z.roll(1, dim)).abs() < REPEAT_TOL)
            self.close[j] += int(near.sum())
            self.pairs[j] += int(both.sum())

    def readings(self):
        """(draw_gap, noise_z, noise_repeat)."""
        if self.n is None:
            return self.gap, math.nan, math.nan
        n = self.n.clamp(min=1)
        z_scale = self.su / torch.sqrt(n / 12.0)
        z_loc = self.ss / torch.sqrt(n)
        has = self.n > 0
        noise_z = float(torch.where(
            has, torch.maximum(z_scale.abs(), z_loc.abs()), 0.0).max()) \
            if bool(has.any()) else math.nan
        repeat = max(cl / p for cl, p in zip(self.close, self.pairs) if p) \
            if any(self.pairs) else math.nan
        return self.gap, noise_z, repeat
