"""The CDQBM's architecture schematic (the counterpart of
``qbmx.utils.viz.visualize_architecture``): input → conv units → pooling →
sequential layers → output nodes, each a box sized by its unit count.
Drawn with matplotlib on the Agg backend (``utils/plots.pyplot``)."""

from __future__ import annotations

import numpy as np

from qbmx_torch.utils.plots import pyplot


def architecture_layers(geo) -> list[tuple[str, str, int]]:
    """``(name, description, units)`` of each layer of ``geo``, input first."""
    layers = [
        ("input", f"{geo.image_shape[0]}×{geo.image_shape[1]}",
         geo.image_shape[0] * geo.image_shape[1]),
        ("conv", f"{geo.conv_dim[0]}×{geo.conv_dim[1]} (k={geo.kernel_size}, "
         f"s={geo.stride}" + (f", C={geo.n_kernels}" if geo.n_kernels > 1 else "") + ")",
         geo.conv_units_total),
    ]
    if geo.has_pooling:
        layers.append((f"pool ({geo.pooling_type})",
                       f"{geo.n_windows} windows of {geo.pooling_size}²", geo.n_pooled))
    for i, s in enumerate(geo.seq_sizes):
        layers.append((f"seq {i}", "dense", s))
    layers.append(("output", "label nodes", geo.n_out))
    return layers


def visualize_architecture(model, save_path: str | None = None):
    """The schematic of ``model.geo``; saved to ``save_path`` when given."""
    plt = pyplot()
    geo = model.geo
    layers = architecture_layers(geo)
    fig, ax = plt.subplots(figsize=(2 + 1.6 * len(layers), 4))
    max_units = max(c for _, _, c in layers)
    for i, (name, desc, count) in enumerate(layers):
        height = 0.2 + 2.6 * np.sqrt(count / max_units)
        ax.add_patch(plt.Rectangle((i * 1.6, -height / 2), 1.0, height,
                                   facecolor="#7aa6c2", edgecolor="black"))
        ax.text(i * 1.6 + 0.5, height / 2 + 0.25, name, ha="center", fontsize=9,
                weight="bold")
        ax.text(i * 1.6 + 0.5, -height / 2 - 0.3, f"{count}\n{desc}", ha="center",
                fontsize=7, va="top")
        if i:
            ax.annotate("", xy=(i * 1.6, 0), xytext=((i - 1) * 1.6 + 1.0, 0),
                        arrowprops=dict(arrowstyle="->"))
    ax.set_xlim(-0.5, len(layers) * 1.6)
    ax.set_ylim(-2.6, 2.6)
    ax.axis("off")
    ax.set_title(f"CDQBM: {geo.n_hidden} hidden + {geo.n_out} output QUBO variables")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig
