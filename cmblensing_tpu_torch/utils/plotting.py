"""Plots of fields, spectra and chains (reference src/plots.jl).

The port's own copy of ``cmblensing_tpu/utils/plotting.py``: host-side
matplotlib on the fields' values fetched from their device. matplotlib is
imported inside the functions, so that the package imports where it is
not installed.
"""
from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def _map_array(f):
    """The first map-basis component of the first batch entry of f, on the
    host."""
    fm = f.to(f.basis.with_space("map"))
    arr = fm.arr.detach().cpu().numpy()
    while arr.ndim > 2:
        arr = arr[0]
    return arr


def plot_map(f, comp=None, ax=None, title=None, vlim=None, cmap="RdBu_r", colorbar=True):
    """A heatmap of (a component of) a field in its map basis, with axes in
    degrees."""
    plt = _plt()
    if comp is not None:
        f = f[comp]
    arr = _map_array(f)
    proj = f.proj
    ext_x = proj.Nx * proj.thetapix / 60
    ext_y = proj.Ny * proj.thetapix / 60
    if ax is None:
        _, ax = plt.subplots()
    if vlim is None:
        vlim = np.percentile(np.abs(arr), 99.5)
    im = ax.imshow(arr, extent=[-ext_x / 2, ext_x / 2, -ext_y / 2, ext_y / 2],
                   vmin=-vlim, vmax=vlim, cmap=cmap, origin="lower")
    ax.set_xlabel("x [deg]")
    ax.set_ylabel("y [deg]")
    if title:
        ax.set_title(title)
    if colorbar:
        plt.colorbar(im, ax=ax)
    return ax


def plot_maps(fields, titles=None, ncol=None, **kwargs):
    """A grid of map plots."""
    plt = _plt()
    fields = list(fields)
    n = len(fields)
    ncol = ncol or min(n, 3)
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 3.2 * nrow), squeeze=False)
    for i, f in enumerate(fields):
        plot_map(f, ax=axes[i // ncol][i % ncol], title=(titles[i] if titles else None), **kwargs)
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    fig.tight_layout()
    return fig


def plot_cls(cls_list, labels=None, ax=None, Dl=True, loglog=True):
    """One or more Cls, as Dl or Cl."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    if not isinstance(cls_list, (list, tuple)):
        cls_list = [cls_list]
    for i, cl in enumerate(cls_list):
        ell = np.asarray(cl.ell)
        y = np.asarray(cl.Cl)
        if Dl:
            y = ell * (ell + 1) * y / (2 * np.pi)
        ax.plot(ell, y, label=labels[i] if labels else None)
    if loglog:
        ax.set_xscale("log")
        ax.set_yscale("log")
    ax.set_xlabel(r"$\ell$")
    ax.set_ylabel(r"$D_\ell$" if Dl else r"$C_\ell$")
    if labels:
        ax.legend()
    return ax


def plot_kde(samples, samples2=None, ax=None, levels=(0.68, 0.95), label=None):
    """A 1-d KDE, or 2-d KDE contours enclosing `levels` of the mass, of
    chain samples."""
    plt = _plt()
    from ..inference.chains import kde
    if ax is None:
        _, ax = plt.subplots()
    if samples2 is None:
        grid, dens = kde(np.asarray(samples))
        ax.plot(grid, dens, label=label)
        ax.set_ylabel("density")
    else:
        gx, gy, dens = kde(np.stack([np.asarray(samples), np.asarray(samples2)], axis=1))
        d = np.sort(dens.ravel())[::-1]
        cum = np.cumsum(d) / d.sum()
        ax.contour(gx, gy, dens, levels=sorted(d[np.searchsorted(cum, lv)] for lv in levels))
    return ax


def animate(fields, filename, fps=5, **kwargs):
    """An animation of a list of fields, written to filename."""
    plt = _plt()
    import matplotlib.animation as manim
    fig, ax = plt.subplots()
    ims = [[ax.imshow(_map_array(f), animated=True, **kwargs)] for f in fields]
    manim.ArtistAnimation(fig, ims, interval=1000 // fps).save(filename, fps=fps)
    return filename
