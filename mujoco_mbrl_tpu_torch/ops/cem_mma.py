"""Staging layout of the tensor-core CEM kernels (csrc/cem_mma.cuh).

The sampler kernels (``csrc/cem_sample_rollout.cu``,
``csrc/cem_sample_rollout_ens.cu``) and the given-action cost kernel
(``csrc/cem_rollout_costs.cu``) run the three products of a model step
on ``mma.sync.m16n8k8`` TF32 with the 3xTF32 split (hi*hi + hi*lo + lo*hi).
This module builds what they read, and says how they map candidates to
rows, so that the CPU tests can check both without a card:

- ``tf32``: round to TF32 as ``cvt.rna.tf32.f32`` does (nearest, ties away
  from zero, 13 low mantissa bits cleared); ``split``: hi = tf32(w),
  lo = tf32(w - hi), what the kernels do to each weight when a block
  stages it (``split_b`` in cem_mma.cuh) and to each activation.
- ``ROW_PERM``: within every 8-block of a weight matrix's rows, B fragment
  row p holds input 8j + ROW_PERM[p], so that a layer's accumulator
  fragment (columns 2t, 2t+1 of a thread) is the next layer's A fragment
  (columns t, t+4).
- ``layout`` / ``pack_weights``: every matrix zero-padded to multiples of
  8, permuted, in fragment order ([k-tile][n-tile][lane] x (b0, b1, b0,
  b1), lane = 4 g + t, b0 = W[8k + ROW_PERM[t]][8n + g], b1 = W[8k +
  ROW_PERM[t + 4]][8n + g]; the kernel stages each float4 as (hi(b0),
  hi(b1), lo(b0), lo(b1))), then the padded biases, goal and cost
  weights: one float32 row per member.
- ``fold_centred``: the kernels roll the state in coordinates centred at
  the replay's state mean mu (x = s - mu). Folding the normalizers as the
  plain version does (``cem_rollout._fold_normalizers``) puts rows of
  1 / std into W1 that cancel against b1 = b1 - (mu / std) W1 for
  near-constant state dimensions; centred, that term drops out exactly,
  the layer-1 product is O(1), and the 3xTF32 representation error (about
  2^-22 of each operand) is no longer amplified by the cancellation.
- ``tile_rows`` / ``tiles_per_env``: which candidate each of the 16 rows of
  a sampler tile holds, with its Philox pair index and sign;
  ``given_rows``: the same for the given-action kernel, whose tile i is
  candidates 16 i .. 16 i + 15 of N, each from its own start state, which
  the kernel centres as it loads it (``centred_weights`` gives the mean it
  subtracts).

The bf16 mode (``compute_dtype=torch.bfloat16``) runs each product as one
``mma.sync.m16n8k16`` of bf16 operands, accumulated in float32:

- ``bf16``: round to bf16 (as float32), nearest-even, what
  ``__float2bfloat16_rn`` gives;
- ``layout_bf16`` / ``pack_weights_bf16``: k padded to multiples of 16
  ([s; a] 30 -> 32, hidden 50 -> 64), n to multiples of 8, in fragment
  order ([k16-tile][n-tile][lane] x (b0.lo, b0.hi, b1.lo, b1.hi), lane =
  4 g + t: W[16k + 2t][8n + g], W[16k + 2t + 1][8n + g], W[16k + 2t +
  8][8n + g], W[16k + 2t + 9][8n + g]), then the padded biases, goal and
  cost weights, every value bf16. The C fragment of n-tiles 2k, 2k + 1
  (columns 2t, 2t + 1 of rows g, g + 8) is already the A fragment of k16
  tile k (columns 2t, 2t + 1, 2t + 8, 2t + 9), so no row permutation. The
  weights are the TPU kernels' uncentred fold
  (``cem_rollout._fold_normalizers``), rounded: the centring of
  ``fold_centred`` serves the float32 kernels only, as the reference rounds
  the uncentred fold.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

ROW_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
MAX_TILES = 16       # k-tiles of [s; a] and hidden tiles the kernels take
MAX_TILES_BF16 = 8   # k16 tiles of [s; a] and of hidden, bf16


class Layout(NamedTuple):
    ni: int      # k-tiles of the layer-1 input [s; a]
    nh: int      # hidden tiles
    nso: int     # state tiles (layer-3 output)
    l1: int      # float offsets: fragment tiles of W1, W2, W3
    l2: int
    l3: int
    b1: int      # padded b1, b2 (8 nh), b3, goal, cost weights (8 ni)
    b2: int
    b3: int
    goal: int
    wvec: int
    total: int   # floats per member, a multiple of 4


def layout(sd: int, ad: int, hid: int) -> Layout:
    """Float offsets of one member's packed weights (cem_mma.cuh
    make_layout)."""
    ni, nh, nso = -(-(sd + ad) // 8), -(-hid // 8), -(-sd // 8)
    l1 = 0
    l2 = l1 + 128 * ni * nh
    l3 = l2 + 128 * nh * nh
    b1 = l3 + 128 * nh * nso
    b2 = b1 + 8 * nh
    b3 = b2 + 8 * nh
    goal = b3 + 8 * ni
    wvec = goal + 8 * ni
    total = -(-(wvec + 8 * ni) // 4) * 4
    return Layout(ni, nh, nso, l1, l2, l3, b1, b2, b3, goal, wvec, total)


def layout_bf16(sd: int, ad: int, hid: int) -> Layout:
    """Offsets in bf16 values of one member's bf16 weights (cem_mma.cuh
    make_layout_bf16): ni and nh count k16 tiles of [s; a] and hidden
    (hidden as n: 2 nh tiles of 8), nso n-tiles of the state; a fragment
    tile is 16 x 8 = 128 values."""
    ni, nh, nso = -(-(sd + ad) // 16), -(-hid // 16), -(-sd // 8)
    l1 = 0
    l2 = l1 + 128 * ni * 2 * nh
    l3 = l2 + 128 * nh * 2 * nh
    b1 = l3 + 128 * nh * nso
    b2 = b1 + 16 * nh
    b3 = b2 + 16 * nh
    goal = b3 + 16 * ni
    wvec = goal + 16 * ni
    total = -(-(wvec + 16 * ni) // 8) * 8
    return Layout(ni, nh, nso, l1, l2, l3, b1, b2, b3, goal, wvec, total)


def check_shapes(what: str, sd: int, ad: int, hid: int,
                 bf16: bool = False) -> Layout:
    """The layout, or a ValueError for shapes the kernels do not take."""
    lay = layout_bf16(sd, ad, hid) if bf16 else layout(sd, ad, hid)
    most = MAX_TILES_BF16 if bf16 else MAX_TILES
    if lay.ni > most or lay.nh > most:
        raise ValueError(
            f'{what}: the tensor-core kernel takes sd + ad <= 128 and '
            f'hidden <= 128 (got sd {sd}, ad {ad}, hidden {hid})')
    return lay


def bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 (as float32), round to nearest, ties to even: what
    ``__float2bfloat16_rn`` gives."""
    return x.to(torch.bfloat16).to(x.dtype)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (as float32), round to nearest, ties away from zero:
    what ``cvt.rna.tf32.f32`` gives."""
    # on the int32 bit pattern: adding half an ulp of TF32 to the
    # magnitude carries into the exponent where it must and cannot reach
    # the sign of a finite value
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3xTF32 split: hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def _pad_matrix_index(rows: int, cols: int, rows_p: int, cols_p: int,
                      row_src, base: int) -> torch.Tensor:
    """(rows_p, cols_p) indices into the flat source (0 = the zero slot):
    padded row r takes source row row_src(r) (None: zero) of a row-major
    (rows, cols) matrix at offset ``base``."""
    idx = torch.zeros((rows_p, cols_p), dtype=torch.int64)
    for r in range(rows_p):
        s = row_src(r)
        if s is not None:
            idx[r, :cols] = base + s * cols + torch.arange(cols)
    return idx


def _fragments(idx: torch.Tensor) -> torch.Tensor:
    """(8 kt, 8 nt) padded matrix indices -> (kt, nt, 32 lanes, 2): lane
    4 g + t takes rows 8k + ROW_PERM[t] and 8k + ROW_PERM[t + 4] of
    column 8n + g."""
    kt, nt = idx.shape[0] // 8, idx.shape[1] // 8
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    perm = torch.tensor(ROW_PERM)
    k = torch.arange(kt)[:, None, None]
    n = torch.arange(nt)[None, :, None]
    col = 8 * n + g
    b0 = idx[8 * k + perm[t], col]
    b1 = idx[8 * k + perm[t + 4], col]
    return torch.stack([b0, b1], dim=-1)


def _fragments_bf16(idx: torch.Tensor) -> torch.Tensor:
    """(16 kt, 8 nt) padded matrix indices -> (kt, nt, 32 lanes, 4): lane
    4 g + t takes rows 16k + 2t, 16k + 2t + 1, 16k + 2t + 8, 16k + 2t + 9
    of column 8n + g (the m16n8k16 B fragment, b0 then b1)."""
    kt, nt = idx.shape[0] // 16, idx.shape[1] // 8
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    k = torch.arange(kt)[:, None, None]
    n = torch.arange(nt)[None, :, None]
    col = 8 * n + g
    rows = [16 * k + 2 * t + d for d in (0, 1, 8, 9)]
    return torch.stack([idx[r, col] for r in rows], dim=-1)


_INDEX_CACHE: Dict[tuple, torch.Tensor] = {}


def _index(sd: int, ad: int, hid: int, device,
           bf16: bool = False) -> torch.Tensor:
    """For every value of the packed layout (float32, or the bf16 layout),
    its source index into the flat vector [0, w1, w2, w3, b1, b2, b3,
    goal, wvec] (0: a zero of the padding)."""
    key = (sd, ad, hid, str(device), bf16)
    if key not in _INDEX_CACHE:
        lay = layout_bf16(sd, ad, hid) if bf16 else layout(sd, ad, hid)
        inn = sd + ad
        o_w1 = 1
        o_w2 = o_w1 + inn * hid
        o_w3 = o_w2 + hid * hid
        o_b1 = o_w3 + hid * sd
        o_b2, o_b3 = o_b1 + hid, o_b1 + 2 * hid
        o_goal = o_b3 + sd
        o_wvec = o_goal + sd
        row = lambda n: (lambda r: r if r < n else None)
        # padded widths: k of [s; a] and of hidden, n of hidden and state
        k_in, k_hid = (16 * lay.ni, 16 * lay.nh) if bf16 else (
            8 * lay.ni, 8 * lay.nh)
        n_hid, n_s = k_hid, 8 * lay.nso
        w1 = _pad_matrix_index(inn, hid, k_in, n_hid, row(inn), o_w1)
        w2 = _pad_matrix_index(hid, hid, k_hid, n_hid, row(hid), o_w2)
        w3 = _pad_matrix_index(hid, sd, k_hid, n_s, row(hid), o_w3)
        if bf16:
            frag = torch.cat([_fragments_bf16(w).reshape(-1, 32, 4)
                              for w in (w1, w2, w3)])
        else:
            # (tiles, 32 lanes, 2) -> (b0, b1, b0, b1) a lane
            frag = torch.cat([_fragments(w).reshape(-1, 32, 2)
                              for w in (w1, w2, w3)]).repeat(1, 1, 2)
        vec = lambda base, n, n_p: torch.cat([
            base + torch.arange(n), torch.zeros(n_p - n, dtype=torch.int64)])
        tail = torch.cat([vec(o_b1, hid, n_hid), vec(o_b2, hid, n_hid),
                          vec(o_b3, sd, k_in), vec(o_goal, sd, k_in),
                          vec(o_wvec, sd, k_in)])
        tail = torch.cat([tail, torch.zeros(lay.total - lay.b1 - tail.numel(),
                                            dtype=torch.int64)])
        _INDEX_CACHE[key] = torch.cat([frag.reshape(-1), tail]).to(device)
    return _INDEX_CACHE[key]


def fold_centred(params, normalizers, s0, goal):
    """The MLP (an optional leading member axis) with the normalizers
    folded in, in coordinates x = s - mu (mu the state mean; 0 without
    normalizers): returns (w1, b1, w2, b2, w3, b3, x0, goal - mu) with
        W1' = W1 / sigma[:, None],  b1' = b1 - (a_mu / a_sigma) W1[sd:],
        W3' = W3 sigma[None, :],    b3' = b3 sigma,
    the same map as ``cem_rollout._fold_normalizers`` shifted by mu on the
    way in and out (sigma = std + 1e-6)."""
    if normalizers is None or normalizers.state_mean is None:
        w = (params[l][k] for l in ('l1', 'l2', 'l3') for k in ('w', 'b'))
        return (*w, s0, goal)
    *w, mu, goal_c = centred_weights(params, normalizers, goal)
    return (*w, s0 - mu, goal_c)


def centred_weights(params, normalizers, goal):
    """``fold_centred`` without the start states: (w1, b1, w2, b2, w3, b3,
    mu, goal - mu), mu (sd,) the state mean (zeros without normalizers),
    which the given-action kernel subtracts from each start state as it
    loads it."""
    w1, b1 = params['l1']['w'], params['l1']['b']
    w2, b2 = params['l2']['w'], params['l2']['b']
    w3, b3 = params['l3']['w'], params['l3']['b']
    if normalizers is None or normalizers.state_mean is None:
        mu = torch.zeros_like(goal)
        return w1, b1, w2, b2, w3, b3, mu, goal - mu
    sd = normalizers.state_mean.shape[-1]
    s_mu, s_sig = normalizers.state_mean, normalizers.state_std + 1e-6
    if normalizers.action_mean is not None:
        a_mu = normalizers.action_mean
        a_sig = normalizers.action_std + 1e-6
        sig = torch.cat([s_sig, a_sig])
        b1 = b1 - (a_mu / a_sig) @ w1[..., sd:, :]
    else:
        sig = torch.cat([s_sig, torch.ones(w1.shape[-2] - sd,
                                           dtype=w1.dtype, device=w1.device)])
    return (w1 / sig[:, None], b1, w2, b2, w3 * s_sig, b3 * s_sig, s_mu,
            goal - s_mu)


def pack_weights(w1, b1, w2, b2, w3, b3, goal, wvec) -> torch.Tensor:
    """Folded MLP weights ((in, hid), (hid,), (hid, hid), (hid,), (hid,
    sd), (sd,), each with an optional leading member axis n) and the cost's
    goal / weights (sd,) -> (n, layout.total) float32 on the weights'
    device (n = 1 without a member axis), as the kernels stage it."""
    return _pack(w1, b1, w2, b2, w3, b3, goal, wvec, bf16=False)


def pack_weights_bf16(w1, b1, w2, b2, w3, b3, goal, wvec) -> torch.Tensor:
    """``pack_weights`` for the bf16 kernels: (n, layout_bf16.total)
    torch.bfloat16, each value rounded to nearest-even."""
    return _pack(w1, b1, w2, b2, w3, b3, goal, wvec, bf16=True)


def _pack(w1, b1, w2, b2, w3, b3, goal, wvec, bf16: bool) -> torch.Tensor:
    lead = w1.shape[:-2]
    n = int(torch.tensor(lead).prod()) if lead else 1
    inn, hid = w1.shape[-2:]
    sd = w3.shape[-1]
    flat = lambda t: t.reshape(n, -1)
    src = torch.cat([
        torch.zeros((n, 1), dtype=w1.dtype, device=w1.device),
        flat(w1), flat(w2), flat(w3), flat(b1), flat(b2), flat(b3),
        goal.reshape(1, sd).expand(n, sd), wvec.reshape(1, sd).expand(n, sd),
    ], dim=1).float()
    packed = src[:, _index(sd, inn - sd, hid, src.device, bf16)]
    return packed.to(torch.bfloat16) if bf16 else packed


class Row(NamedTuple):
    k: int         # candidate
    pair: int      # Philox pair index (counter word 2)
    sign: float    # -1.0 for the antithetic half
    valid: bool


def shared_pairs(K: int, n: int, antithetic: bool) -> bool:
    """Whether rows g and g + 8 of a tile hold an antithetic pair (its two
    candidates k and k + ceil(K/2) then belong to one member)."""
    return bool(antithetic) and ((K + 1) // 2) % n == 0


def tiles_per_env(K: int, n: int = 1, antithetic: bool = True) -> int:
    """Tiles of 16 rows per (member, env) (cem_mma.cuh tiling)."""
    if shared_pairs(K, n, antithetic):
        return -(-((K + 1) // 2 // n) // 8)
    return -(-(K // n) // 16)


def tile_rows(K: int, n: int, antithetic: bool, m: int, i: int):
    """The 16 rows of tile i of member m (cem_mma.cuh row_of): with shared
    pairs row g holds pair q = 8 i + g's first candidate k = q n + m and
    row g + 8 its partner k + ceil(K/2); otherwise row r holds candidate
    (16 i + r) n + m, whose pair is k or k - ceil(K/2)."""
    Kz = (K + 1) // 2 if antithetic else K
    rows = []
    for r in range(16):
        if shared_pairs(K, n, antithetic):
            q = 8 * i + (r & 7)
            k0 = q * n + m
            k = k0 if r < 8 else k0 + Kz
            rows.append(Row(k, k0, 1.0 if r < 8 else -1.0,
                            q < Kz // n and k < K))
        else:
            q = 16 * i + r
            k = q * n + m
            second = bool(antithetic) and k >= Kz
            rows.append(Row(k, k - Kz if second else k,
                            -1.0 if second else 1.0, q < K // n))
    return rows


def given_tiles(N: int) -> int:
    """Tiles of 16 candidates of the given-action kernel."""
    return -(-N // 16)


def given_rows(N: int, i: int):
    """The 16 rows of the given-action kernel's tile i: row r holds
    candidate 16 i + r (rows g and g + 8 of a quad's thread: 16 i + g and
    16 i + g + 8), valid below N; no pairs, no sign."""
    return [Row(16 * i + r, 16 * i + r, 1.0, 16 * i + r < N)
            for r in range(16)]
