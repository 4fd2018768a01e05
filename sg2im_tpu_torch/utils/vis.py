"""Visualization: scene-graph rendering (GraphViz) and layout drawing.

The port's own copy of ``sg2im_tpu/utils/vis.py`` (upstream
``sg2im/vis.py``), host-side numpy, pyplot and ``dot``.  GraphViz rendering
shells out to ``dot`` as upstream does (``vis.py:110-192``); callers check
:func:`have_graphviz` first and skip the renders without it.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np


def have_graphviz() -> bool:
    try:
        subprocess.run(["dot", "-V"], capture_output=True, check=False)
        return True
    except FileNotFoundError:
        return False


def draw_scene_graph(objs, triples, vocab=None, output_filename=None,
                     orientation="V", edge_width=6, arrow_size=1.5,
                     binary_edge_weight=1.2, ignore_dummies=True):
    """Render a scene graph to an RGB array via GraphViz.

    Mirrors reference ``draw_scene_graph`` (``sg2im/vis.py:110-192``): object
    nodes pink, predicate nodes blue, ``__image__``/``__in_image__`` dummies
    skipped by default.  ``objs``/``triples`` are name lists, or index
    arrays when ``vocab`` is given.
    """
    if orientation not in ("V", "H"):
        raise ValueError(f'Invalid orientation "{orientation}"')
    rankdir = {"H": "LR", "V": "TD"}[orientation]

    if vocab is not None:
        objs = [vocab["object_idx_to_name"][int(i)] for i in np.asarray(objs)]
        triples = [
            [int(s), vocab["pred_idx_to_name"][int(p)], int(o)]
            for s, p, o in np.asarray(triples)
        ]

    lines = [
        "digraph{",
        'graph [size="5,3",ratio="compress",dpi="300",bgcolor="transparent"]',
        f"rankdir={rankdir}",
        'nodesep="0.5"',
        'ranksep="0.5"',
        'node [shape="box",style="rounded,filled",fontsize="48",color="none"]',
        'node [fillcolor="lightpink1"]',
    ]
    for i, obj in enumerate(objs):
        if ignore_dummies and obj == "__image__":
            continue
        lines.append(f'{i} [label="{obj}"]')
    next_node_id = len(objs)
    lines.append('node [fillcolor="lightblue1"]')
    for s, p, o in triples:
        if ignore_dummies and p == "__in_image__":
            continue
        lines += [
            f'{next_node_id} [label="{p}"]',
            f"{s}->{next_node_id} [penwidth={edge_width},"
            f"arrowsize={arrow_size},weight={binary_edge_weight}]",
            f"{next_node_id}->{o} [penwidth={edge_width},"
            f"arrowsize={arrow_size},weight={binary_edge_weight}]",
        ]
        next_node_id += 1
    lines.append("}")

    with tempfile.TemporaryDirectory() as td:
        dot_path = os.path.join(td, "sg.dot")
        out_path = output_filename or os.path.join(td, "sg.png")
        fmt = os.path.splitext(out_path)[1][1:] or "png"
        with open(dot_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(out_path, "wb") as f:
            subprocess.run(["dot", f"-T{fmt}", dot_path], stdout=f, check=True)
        from PIL import Image

        img = np.asarray(Image.open(out_path).convert("RGB"))
    return img


def draw_layout(vocab, objs, boxes, masks=None, size=256, show_boxes=False,
                bgcolor=(0, 0, 0)):
    """Matplotlib layout rendering (reference ``sg2im/vis.py:30-77``):
    rainbow-colored soft masks placed in their boxes over a solid
    background; ``__image__`` nodes skipped.  Draws into the current pyplot
    axes (use ``plt.savefig``/``plt.gcf()`` to capture)."""
    import matplotlib.pyplot as plt

    if bgcolor == "white":
        bgcolor = (255, 255, 255)
    objs = np.asarray(objs)
    boxes = np.asarray(boxes, np.float64) * size
    cmap = plt.get_cmap("rainbow")
    colors = cmap(np.linspace(0, 1, len(objs)))

    bg = np.ones((size, size, 1)) * np.asarray(bgcolor)
    plt.imshow(bg.astype(np.uint8))
    plt.gca().set_xlim(0, size)
    plt.gca().set_ylim(size, 0)
    plt.gca().set_aspect(1.0, adjustable="box")

    for i, obj in enumerate(objs):
        name = vocab["object_idx_to_name"][int(obj)]
        if name == "__image__":
            continue
        if masks is None:
            continue
        mask = np.asarray(masks[i], np.float64)
        mask = mask / max(mask.max(), 1e-8)
        colored = mask[:, :, None] * np.asarray(colors[i])
        x0, y0, x1, y1 = boxes[i]
        plt.imshow(colored, extent=(x0, x1, y1, y0),
                   interpolation="bicubic", alpha=1.0)

    if show_boxes:
        for i, obj in enumerate(objs):
            name = vocab["object_idx_to_name"][int(obj)]
            if name == "__image__":
                continue
            draw_box(boxes[i], colors[i], name)


def draw_box(box, color, text=None):
    """Draw one bounding box (+label) with pyplot
    (reference ``sg2im/vis.py:80-107``)."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    TEXT_BOX_HEIGHT = 10
    x0, y0, x1, y1 = np.asarray(box).reshape(-1)
    assert y1 > y0 and x1 > x0, box
    w, h = x1 - x0, y1 - y0
    rect = Rectangle((x0, y0), w, h, fc="none", lw=2, ec=color)
    plt.gca().add_patch(rect)
    if text is not None:
        text_rect = Rectangle((x0, y0), w, TEXT_BOX_HEIGHT, fc=color,
                              alpha=0.5)
        plt.gca().add_patch(text_rect)
        tx = 0.5 * (x0 + x1)
        ty = y0 + TEXT_BOX_HEIGHT / 2.0
        plt.text(tx, ty, text, va="center", ha="center")


def draw_layout_array(boxes, obj_names, H=256, W=256):
    """Simple rasterized layout preview (box outlines burned into an array).

    A dependency-light stand-in for the matplotlib drawing at
    ``sg2im/vis.py:30-107``; returns (H, W, 3) uint8.
    """
    canvas = np.full((H, W, 3), 255, np.uint8)
    rng = np.random.RandomState(0)
    for i, box in enumerate(np.asarray(boxes)):
        color = rng.randint(0, 200, 3)
        x0, y0, x1, y1 = (np.clip(box, 0, 1) * [W - 1, H - 1, W - 1, H - 1]
                          ).astype(int)
        canvas[y0:y1 + 1, x0, :] = color
        canvas[y0:y1 + 1, x1, :] = color
        canvas[y0, x0:x1 + 1, :] = color
        canvas[y1, x0:x1 + 1, :] = color
    return canvas
