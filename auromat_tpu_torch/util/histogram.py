"""Multi-weight 2D histogram, counterpart of ``auromat_tpu.util.histogram``.

The reference vendors a searchsorted-based histogram2d with a list-of-weights
extension so count+R+G+B+elevation bin in one coordinate pass
(auromat/util/histogram.py:32-49). The list-of-weights case runs in torch on
``device`` (the card by default): one float64 ``searchsorted`` pass shared by
every weight, then one float64 ``index_add_`` per weight. The single-weight
case and :func:`histogramdd` pass through to numpy, as in the JAX package.
"""

import numpy as np
import torch

from auromat_tpu_torch.ops.georef import compute_device


def _flat(a, device):
    """``a`` (array, list or tensor) as a flat tensor on ``device``, its
    dtype kept."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.reshape(-1).to(device)


def _extent(t):
    """(min, max) of ``t`` as numpy scalars of its own dtype: numpy's
    ``linspace`` then makes the edges in that dtype, as the JAX package's
    ``x.min()``/``x.max()`` do."""
    return tuple(v.cpu().numpy()[()] for v in (t.min(), t.max()))


def _digitize(v, lo, hi, n, device):
    """Bin index of each value of ``v`` among n equal bins over [lo, hi],
    the right-most edge inclusive, NaN out of range (numpy sorts it last);
    returns (index, edges as numpy). Values and edges compare in float64,
    which holds both exactly. The right edge compares as the JAX package's
    ``x == xhi`` does, in numpy's promotion of the two: a Python float is
    weak there, so float32 samples meet float32(hi)."""
    edges = np.linspace(lo, hi, n + 1)
    cmp = np.result_type(torch.empty(0, dtype=v.dtype).numpy().dtype, hi)
    at_hi = v.to(torch.from_numpy(np.empty(0, cmp)).dtype) == \
        np.asarray(hi).astype(cmp).item()
    v = v.double()
    i = torch.searchsorted(torch.from_numpy(edges).to(device).double(), v,
                           right=True) - 1
    i = torch.where(at_hi, n - 1, i)
    return torch.where(torch.isnan(v), n, i), edges


def histogram2d(x, y, bins, range=None, weights=None, device="cuda"):
    """numpy.histogram2d with support for a LIST of weights arrays.

    :param x, y: sample coordinates (arrays or tensors)
    :param weights: None, an array, or a list where each element is None
        (count) or a weight array; one shared bin pass serves all of them.
        Only the list case computes on ``device``.
    :returns: (hist or list of float64 numpy hists, xedges, yedges)
    """
    if not isinstance(weights, list):
        return np.histogram2d(np.asarray(x), np.asarray(y), bins=bins,
                              range=range, weights=weights)
    device = compute_device(device)
    try:
        nx, ny = bins
    except TypeError:
        nx = ny = bins
    xt, yt = _flat(x, device), _flat(y, device)
    if range is not None:
        (xlo, xhi), (ylo, yhi) = range
    else:
        (xlo, xhi), (ylo, yhi) = _extent(xt), _extent(yt)

    # single digitize pass shared by all weights
    ix, xedges = _digitize(xt, xlo, xhi, nx, device)
    iy, yedges = _digitize(yt, ylo, yhi, ny, device)
    valid = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    flat = (ix * ny + iy)[valid]

    hists = []
    for w in weights:
        wv = (torch.ones(flat.shape, dtype=torch.float64, device=device)
              if w is None else _flat(w, device).double()[valid])
        h = torch.zeros(nx * ny, dtype=torch.float64, device=device)
        hists.append(h.index_add_(0, flat, wv).reshape(nx, ny).cpu().numpy())
    return hists, xedges, yedges


def histogramdd(sample, bins, range=None, weights=None, device="cuda"):
    """numpy.histogramdd passthrough with list-of-weights support (2D only
    for the list case, which computes on ``device``)."""
    if isinstance(weights, list):
        x, y = np.asarray(sample).T if np.asarray(sample).ndim == 2 else sample
        return histogram2d(x, y, bins, range, weights, device=device)
    return np.histogramdd(sample, bins=bins, range=range, weights=weights)
