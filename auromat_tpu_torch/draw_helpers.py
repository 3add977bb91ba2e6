"""Polygon generation and figure plumbing for the drawing layer.

Counterpart of ``auromat_tpu.draw_helpers``: host numpy over the port's
host :class:`~auromat_tpu_torch.mapping.mapping.Mapping` (numpy masked
arrays), with matplotlib imported inside the functions that draw, so the
module imports where matplotlib is not installed. Mirrors
auromat/draw_helpers.py: pixel-corner grids become (h*w, 4, 2)
PolyCollection vertex arrays with per-pixel colors, NaN quads filtered via
the mask guarantees; mapping collections are merged with elevation-sorted
overlap ordering (higher-elevation pixels drawn last).
"""

import numpy as np
import numpy.ma as ma


def create_polygons_and_colors(lats, lons, rgb, elevation=None):
    """Corner grids + rgb -> (verts (n,4,2), colors (n,3or4), elev (n,)).

    Vertex order per quad: (y,x), (y,x+1), (y+1,x+1), (y+1,x); NaN quads are
    dropped (reference draw_helpers.py:34-79).
    """
    lats = np.asarray(ma.filled(lats, np.nan))
    lons = np.asarray(ma.filled(lons, np.nan))
    ll = np.stack([lons, lats], axis=-1)  # (x=lon, y=lat) plot order
    verts = np.stack(
        [ll[:-1, :-1], ll[:-1, 1:], ll[1:, 1:], ll[1:, :-1]], axis=2
    ).reshape(-1, 4, 2)
    colors = np.asarray(ma.filled(rgb, 0)).reshape(-1, rgb.shape[-1])
    if np.issubdtype(colors.dtype, np.integer):
        colors = colors / 255.0
    has_nan = np.isnan(verts).any(axis=(1, 2))
    # ALSO drop quads whose pixel (centre) is masked: the sanitize fixpoint
    # keeps boundary corners valid while the centre is masked, and filling
    # the masked colour with 0 would paint a spurious black ring along
    # every mask boundary (reference filterNanPolygons filters by the
    # colour mask)
    center_masked = ma.getmaskarray(rgb).reshape(-1, rgb.shape[-1]).any(axis=1)
    keep = ~has_nan & ~center_masked
    out_elev = None
    if elevation is not None:
        ev = np.asarray(ma.filled(elevation, np.nan)).ravel()
        out_elev = ev[keep]
    return verts[keep], colors[keep], out_elev


def polygons_from_mapping_or_collection(mapping_or_collection, mlatmlt=False):
    """(verts, colors) merged over a mapping or collection.

    For collections with mayOverlap, quads of all mappings are joined and
    sorted by elevation so higher-elevation (better-viewed) pixels overdraw
    (reference draw_helpers.py:128-178).
    """
    from auromat_tpu_torch.mapping.mapping import MappingCollection

    if isinstance(mapping_or_collection, MappingCollection):
        mappings = mapping_or_collection.mappings
        sort = mapping_or_collection.mayOverlap
    else:
        mappings = [mapping_or_collection]
        sort = False

    all_verts, all_colors, all_elev = [], [], []
    for m in mappings:
        if mlatmlt:
            mlat, mlt = m.mLatMlt
            lats, lons = mlat, mlt
        else:
            lats, lons = m.lats, m.lons
        verts, colors, elev = create_polygons_and_colors(
            lats, lons, m.rgb, m.elevation
        )
        all_verts.append(verts)
        all_colors.append(colors)
        if elev is not None:
            all_elev.append(elev)
    verts = np.concatenate(all_verts)
    colors = np.concatenate(all_colors)
    if sort and all_elev:
        elev = np.concatenate(all_elev)
        if len(elev) != len(verts):
            raise ValueError(
                "mayOverlap collections need elevation on every mapping "
                "for overlap ordering (a mapping without elevation would "
                "silently drop polygons)")
        order = np.argsort(np.nan_to_num(elev, nan=-1))
        verts, colors = verts[order], colors[order]
    return verts, colors


def overlap_polygons(verts, factor=0.2):
    """Slightly grow quads towards preventing hairline seams between
    adjacent polygons in matplotlib (reference draw_helpers.py:92-105)."""
    center = verts.mean(axis=1, keepdims=True)
    return center + (verts - center) * (1.0 + factor)


def mlt_formatter(value, pos=None):
    """Tick formatter for magnetic local time axes (reference
    draw_helpers.py:207). Minutes carry into hours (16.995 -> "17:00",
    not "16:60") and negatives wrap."""
    total_minutes = int(round(value * 60)) % (24 * 60)
    hours, minutes = divmod(total_minutes, 60)
    return f"{hours:02d}:{minutes:02d}"


def figure_image(fig):
    """Render a matplotlib figure into an RGB uint8 array."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[:, :, :3].copy()


def set_colors(fig_or_figax, bgcolor="white", transparent=False):
    """Switch a figure between the white/black color schemes.

    Recolors the figure/axes background and every axis decoration (spines,
    tick marks/labels, axis labels, titles and other text) so plots can be
    produced for either background after the fact (reference
    draw.py:1958-1971 setColors + draw_helpers.py:327-363 _setMplColors).

    :param fig_or_figax: a Figure, or a (fig, ax, ...) sequence
    :param bgcolor: 'white' or 'black' plot background
    :param transparent: transparent background outside the plot bounds
    """
    from matplotlib.figure import Figure
    from matplotlib.text import Text

    if isinstance(fig_or_figax, Figure):
        fig, axes = fig_or_figax, fig_or_figax.axes
    else:
        fig = fig_or_figax[0]
        axes = [fig_or_figax[1]]
    textcolor = "white" if bgcolor == "black" else "black"
    facecolor = "none" if transparent else bgcolor
    fig.patch.set_facecolor(facecolor)
    for ax in axes:
        ax.set_facecolor(facecolor)
        for spine in ax.spines.values():
            spine.set_color(textcolor)
        ax.tick_params(colors=textcolor, which="both")
        ax.xaxis.label.set_color(textcolor)
        ax.yaxis.label.set_color(textcolor)
        for t in ax.findobj(Text):
            t.set_color(textcolor)
    for t in fig.texts:
        t.set_color(textcolor)
    return fig


def save_fig(path, fig, dpi=None, transparent=False, width_px=None):
    """Save and close a figure (reference draw.py:1937-1956).

    :param width_px: target raster width in pixels (sets dpi accordingly)
    """
    if width_px is not None and dpi is None:
        dpi = width_px / fig.get_size_inches()[0]
    fig.savefig(path, dpi=dpi, transparent=transparent,
                bbox_inches="tight", pad_inches=0.1)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def ensure_continuous_path(points):
    """Reorder at most two logical segments of a pixel path into one
    continuous segment (reference draw_helpers.py:261-280: scanline
    outlines traced from a seam can come out as end-half + start-half)."""
    points = np.asarray(points)
    if len(points) < 3:
        return points
    vecs = points[1:] - points[:-1]
    len_sq = (vecs * vecs).sum(axis=1)
    jumps = len_sq > 2
    if np.any(jumps):
        jump_idx = int(np.argmax(jumps))
        return np.concatenate((points[jump_idx + 1:], points[:jump_idx + 1]))
    return points


def load_fig_image(im, dpi=80):
    """Figure with a raster image spanning the full canvas and data
    coordinates equal to pixel coordinates (reference
    draw_helpers.py:298-325); base canvas for image-space overlays.

    :param im: image path or RGB array
    :rtype: (Figure, Axes)
    """
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    from auromat_tpu_torch.io.image import image_to_mpl, load_image

    if isinstance(im, str):
        im = load_image(im)
    im = image_to_mpl(im)
    h, w = im.shape[0], im.shape[1]
    fig = plt.figure(figsize=(w / dpi, h / dpi), dpi=dpi)
    ax = plt.Axes(fig, [0, 0, 1, 1])
    ax.set_xlim(0, w)
    ax.set_ylim(0, h)
    ax.invert_yaxis()
    ax.set_axis_off()
    fig.add_axes(ax)
    fig.figimage(im, cmap=cm.gray if im.ndim == 2 else None)
    return fig, ax
