"""Peaks of the card and the bytes a kernel must move, computed from shapes.

Frozen here so that later changes to the program cannot move the
yardstick: the peaks are NVIDIA's published H100 SXM figures (at the full
700 W power limit), and ``bin_bytes`` is the count the port's kernel table
has used for K1 since its redesign.
"""

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(n_bytes):
    """The least time the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S


def bin_bytes(idx_bytes, n_samples, n_valid, in_ch, n_cells, out_words, out_bytes=4):
    """Bytes a binning kernel must move: every sample's two cell indices of
    ``idx_bytes`` each, the ``in_ch`` float32 channels of the valid samples
    (each read once), and ``out_words`` words of ``out_bytes`` a cell
    (each written once)."""
    return (2 * idx_bytes * n_samples + 4 * in_ch * n_valid
            + out_bytes * out_words * n_cells)


def k1_bytes(n_samples, n_valid, n_cells, int_sums):
    """K1's bytes for one launch: int32 row and column indices of every
    sample, R, G, B and elevation of the valid ones, and per output cell
    either the five float32 outputs its fused epilogue writes for every
    cell of the grid or, with ``int_sums``, the five int64 sums it adds
    into each cell its samples touch (``n_cells`` is then that count)."""
    return bin_bytes(4, n_samples, n_valid, 4, n_cells, 5, 8 if int_sums else 4)
