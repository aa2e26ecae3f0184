"""Preamble synchronization: Schmidl-Cox autocorrelation + xcorr refinement.

Re-design of modem.js:235-319 and the fine search of modem.js:567-588 for
an accelerator. The reference's O(1)-per-sample sliding recurrences are
sequential; here everything is parallel over positions, streams and frames:

* window sums via doubling decomposition (exact pairwise trees, no
  long-range float32 cancellation, no O(T*window) conv) — optionally only
  at stride-aligned positions for the coarse scan;
* template cross-correlation as a block-Toeplitz matmul against a
  128-row shifted template bank (sliding_correlate).

All functions take a traced ``n_valid`` so one compiled executable serves
any signal length within a padding bucket.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from audio_modem_tpu.configs import OfdmProfile

# Detection thresholds (modem.js:306,318 / app.js:801,826)
AUTOCORR_THRESHOLD = 0.5
AUTOCORR_MIN_ENERGY = 0.01
XCORR_THRESHOLD = 0.1
XCORR_MIN_DENOM = 0.001
# Coarse-scan stride: safe up to CP_LEN/4 (see detect_preamble docstring);
# the smallest CP is 64, so 16 works for every profile.
COARSE_STRIDE = 16


def windowed_sum(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Sliding-window sum over the last axis, 'valid' mode:
    [..., T] -> [..., T - window + 1].

    Doubling decomposition (Hillis-Steele over windows): build
    S_k[d] = sum_{j<k} x[d+j] for powers of two by S_2k[d] = S_k[d] + S_k[d+k],
    then compose the binary expansion of ``window`` with shifted adds. Exact
    pairwise-tree summation (no long-range float32 cancellation, unlike a
    global-cumsum difference), O(T log window) vector adds (unlike the
    O(T * window) ones-kernel conv), shift-only memory access (no gathers),
    and fully batched over leading axes. Works for any window/T.
    """
    t = x.shape[-1]
    x = x.astype(jnp.float32)
    powers = [1 << b for b in range(window.bit_length()) if window & (1 << b)]
    top = max(powers)
    cache = {1: x}
    k = 1
    while 2 * k <= top:
        s = cache[k]
        cache[2 * k] = s[..., : s.shape[-1] - k] + s[..., k:]
        k *= 2
    n_pos = t - window + 1
    out = None
    off = 0
    for pk in sorted(powers, reverse=True):
        seg = cache[pk][..., off : off + n_pos]
        out = seg if out is None else out + seg
        off += pk
    return out


def preprocess(signal: jnp.ndarray, n_valid: jnp.ndarray) -> jnp.ndarray:
    """DC removal + unit-peak normalization over the valid region
    (modem.js:213-232), keeping zero padding at zero.

    ``n_valid`` broadcasts against the leading (batch) dims of ``signal``.
    """
    t = signal.shape[-1]
    nv = jnp.asarray(n_valid)[..., None]  # [..., 1]
    mask = jnp.arange(t) < nv
    sig = jnp.where(mask, signal, 0.0).astype(jnp.float32)
    mean = sig.sum(axis=-1, keepdims=True) / jnp.maximum(nv.astype(jnp.float32), 1.0)
    out = jnp.where(mask, sig - mean, 0.0)
    mx = jnp.abs(out).max(axis=-1, keepdims=True)
    scale = jnp.where(mx > 1e-6, 1.0 / jnp.where(mx > 1e-6, mx, 1.0), 1.0)
    return out * scale


def _strided_windowed_sum(x: jnp.ndarray, window: int, stride: int) -> jnp.ndarray:
    """Window sums only at stride-aligned positions: [..., T] ->
    [..., (T - window)//stride + 1], exact.

    Reshape-sum into stride-sized blocks (one pass over x), then a doubling
    windowed sum over the block array (window//stride wide) — total traffic
    ~stride-times less than the dense version.
    """
    *lead, t = x.shape
    nb = t // stride
    blocks = x[..., : nb * stride].reshape(*lead, nb, stride).sum(axis=-1)
    return windowed_sum(blocks, window // stride)


def detect_preamble(
    signal: jnp.ndarray,
    profile: OfdmProfile,
    n_valid: jnp.ndarray,
    min_pos: jnp.ndarray | int = 0,
    min_energy: float = AUTOCORR_MIN_ENERGY,
    stride: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Coarse Schmidl-Cox scan, batched over [..., T].

    Metric P^2/(Ra*Rb) (sign-insensitive Pearson r^2 — required because
    acoustic/narrowband preambles are anti-periodic, SURVEY §2 #10), windows
    per modem.js:286-314.

    Peak selection deliberately uses the reference's STREAMING semantics
    (app.js:829-839) — commit the first peak > 0.5 once the metric falls
    below 0.7x its running max — instead of the global argmax of
    modem.js:304-318. The global argmax is a documented reference bug:
    payloads with long zero-bit runs (e.g. the big-endian length/seq fields)
    under repetition coding yield IDENTICAL consecutive OFDM symbols whose
    lag-256 correlation is exactly 1.0, strictly above the true preamble's
    post-preprocessing metric, so the reference's manual-receive path
    mis-syncs on its own signals. First-peak commit decodes everything the
    reference encodes (the preamble always precedes data) and matches its
    real-time receiver.

    ``min_pos`` masks positions before it (used for host-side retry after a
    refinement false-positive). Returns (best_idx int32 [...], best_metric
    f32 [...]); best_idx = -1 when best_metric <= 0.5.

    ``stride`` > 1 evaluates the metric only at stride-aligned positions —
    exact window sums, ~stride-times less device-memory traffic. Safe whenever
    stride <= CP_LEN/4: the preamble's metric plateau is CP_LEN+1 positions
    wide (every window start for which [d, d+512) lies inside CP+body), so a
    stride-aligned point always lands on it, and the ±3*CP xcorr refinement
    recovers the exact start. Must divide fft_size/2.
    """
    half = profile.fft_size // 2
    assert half % stride == 0, "stride must divide the half-symbol window"
    t = signal.shape[-1]
    s = signal.astype(jnp.float32)

    prod = s[..., : t - half] * s[..., half:]
    if stride == 1:
        n_pos = t - 2 * half + 1
        p = windowed_sum(prod, half)[..., :n_pos]
        e = windowed_sum(s * s, half)
    else:
        p = _strided_windowed_sum(prod, half, stride)
        e = _strided_windowed_sum(s * s, half, stride)
        n_pos = min(p.shape[-1], e.shape[-1] - half // stride)
        p = p[..., :n_pos]
    hs = half // stride
    ra = e[..., :n_pos]
    rb = e[..., hs : hs + n_pos]

    d = jnp.arange(n_pos) * stride
    in_range = (d <= (jnp.asarray(n_valid)[..., None] - 2 * half)) & (
        d >= jnp.asarray(min_pos)[..., None]
    )
    energetic = (ra > min_energy) & (rb > min_energy)
    valid = in_range & energetic
    metric = jnp.where(valid, (p * p) / jnp.where(valid, ra * rb, 1.0), 0.0)

    # First-peak commit: stop at the first position where the metric has
    # dropped below 0.7x the running max (and the running max cleared the
    # detection threshold); take the argmax of the prefix up to that point.
    k = jnp.arange(n_pos)  # strided-array indices (positions = k * stride)
    runmax = jax.lax.cummax(metric, axis=metric.ndim - 1)
    drop = (runmax > AUTOCORR_THRESHOLD) & (metric < 0.7 * runmax)
    has_drop = drop.any(axis=-1)
    first_drop = jnp.where(has_drop, jnp.argmax(drop, axis=-1), n_pos - 1)
    prefix = jnp.where(k <= first_drop[..., None], metric, 0.0)
    best = prefix.max(axis=-1)
    idx = (prefix.argmax(axis=-1) * stride).astype(jnp.int32)
    return jnp.where(best > AUTOCORR_THRESHOLD, idx, -1), best


@lru_cache(maxsize=None)
def _template(profile: OfdmProfile) -> tuple[np.ndarray, float]:
    pre1 = profile.preamble1
    t_energy = float((pre1.astype(np.float64) ** 2).sum())
    return pre1, t_energy


_LANE = 128


@lru_cache(maxsize=None)
def _template_bank(profile: OfdmProfile) -> np.ndarray:
    """[128, W] bank of lane-shifted preamble-1 copies for block-Toeplitz
    correlation: bank[r, m] = pre1[m - r], W = ceil((plen+127)/128)*128."""
    pre1 = profile.preamble1.astype(np.float32)
    plen = len(pre1)
    w = -(-(plen + _LANE - 1) // _LANE) * _LANE
    bank = np.zeros((_LANE, w), dtype=np.float32)
    for r in range(_LANE):
        bank[r, r : r + plen] = pre1
    return bank


def sliding_correlate(x: jnp.ndarray, profile: OfdmProfile) -> jnp.ndarray:
    """corr[d] = sum_j x[d+j] * pre1[j] for every d: [..., L] -> [..., L-plen+1].

    Block-Toeplitz matmul formulation: for d = 128q + r,
    corr[d] = (x row-block starting at 128q, width W) . bank[r], so the whole
    correlation is one [n_tiles, W] @ [W, 128] matmul per signal instead of
    an O(L*plen) sliding-window conv.
    The overlapping row-blocks come from concatenating W/128 consecutive
    non-overlapping 128-blocks (static slices, no gathers).
    """
    plen = profile.symbol_len
    bank = jnp.asarray(_template_bank(profile))
    w = bank.shape[1]
    *lead, l = x.shape
    n_pos = l - plen + 1
    nt = -(-n_pos // _LANE)
    need = _LANE * (nt - 1) + w
    xp = jnp.pad(x.astype(jnp.float32), [(0, 0)] * len(lead) + [(0, max(0, need - l))])
    blocks = xp[..., : _LANE * (nt - 1 + w // _LANE)].reshape(*lead, nt - 1 + w // _LANE, _LANE)
    rows = jnp.concatenate(
        [blocks[..., j : j + nt, :] for j in range(w // _LANE)], axis=-1
    )  # [..., nt, W]
    corr = jnp.matmul(rows, bank.T, precision=jax.lax.Precision.HIGHEST)  # [..., nt, 128]
    return corr.reshape(*lead, nt * _LANE)[..., :n_pos]


def detect_preamble_xcorr(
    signal: jnp.ndarray, profile: OfdmProfile, n_valid: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full-signal normalized cross-correlation detector (modem.js:235-283).

    The reference's fallback for when autocorrelation fails (used by the
    loopback analyzer, modem.js:980-984): correlate against the regenerated
    preamble-1 template. The reference scans coarsely (step = pLen/10) then
    finely around the winner; here the dense scan is one correlation matmul,
    so we evaluate every position directly — a strict superset of the
    reference's two-pass search, same 0.15 threshold.

    Returns (best_idx int32, best_metric f32); best_idx = -1 below threshold.
    """
    pre1, t_energy = _template(profile)
    plen = profile.symbol_len
    t = signal.shape[-1]
    s = signal.astype(jnp.float32)
    corr = sliding_correlate(s, profile)  # block-Toeplitz matmul
    s_energy = windowed_sum(s * s, plen)
    denom = jnp.sqrt(s_energy * t_energy)
    d = jnp.arange(t - plen + 1)
    ok = (denom > XCORR_MIN_DENOM) & (d <= jnp.asarray(n_valid)[..., None] - plen)
    metric = jnp.where(ok, corr / jnp.where(ok, denom, 1.0), 0.0)
    best = metric.max(axis=-1)
    idx = metric.argmax(axis=-1).astype(jnp.int32)
    return jnp.where(best > 0.15, idx, -1), best


def refine_xcorr(
    signal: jnp.ndarray,
    coarse_idx: jnp.ndarray,
    profile: OfdmProfile,
    n_valid: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fine normalized cross-correlation around ``coarse_idx``
    (modem.js:567-588): d in [max(0, c-3CP), min(n_valid-plen, c+3CP)].

    Single-signal version (no leading batch axis). The caller must ensure the
    padded signal extends at least ``2*radius + 2*symbol_len`` past n_valid so
    all slices are static-size and in bounds.

    Returns (start_idx int32, best_metric f32); start_idx falls back to
    coarse_idx when no position has sufficient energy, like the reference.
    """
    pre1, t_energy = _template(profile)
    plen = profile.symbol_len
    radius = 3 * profile.cp_len
    n_off = 2 * radius + 1
    region_len = n_off + plen - 1

    lo = jnp.clip(coarse_idx - radius, 0, None).astype(jnp.int32)
    hi = jnp.minimum(n_valid - plen, coarse_idx + radius)

    region = jax.lax.dynamic_slice(signal, (lo,), (region_len,)).astype(jnp.float32)
    corr = sliding_correlate(region, profile)  # block-Toeplitz matmul
    s_energy = windowed_sum(region * region, plen)
    denom = jnp.sqrt(s_energy * t_energy)

    d_global = lo + jnp.arange(n_off)
    ok = (denom > XCORR_MIN_DENOM) & (d_global <= hi)
    metric = jnp.where(ok, corr / jnp.where(ok, denom, 1.0), -jnp.inf)

    best = metric.max()
    best_idx = jnp.where(jnp.isfinite(best), (lo + metric.argmax()).astype(jnp.int32), coarse_idx)
    return best_idx, best
