"""Dev graph tooling: namespace dot-graph and circuit layout rendering.

Reference: halo2_proofs/src/dev/graph.rs:20 (circuit_dot_graph) and
graph/layout.rs:39-85 (CircuitLayout plotters PNG). The layout renderer
here emits structured text/SVG rather than plotters bitmaps.

Copied from halo2_tpu/dev/graph.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from .mock_prover import MockProver


def circuit_dot_graph(k: int, circuit, instance=None, fs=None) -> str:
    """Render the region/namespace tree as graphviz dot."""
    prover = MockProver.run(k, circuit, instance or [], fs=fs)
    lines = ["digraph circuit {", "  root [label=\"circuit\"];"]
    for region in prover.regions:
        rid = f"r{region.index}"
        label = region.name.replace('"', "'")
        lines.append(f'  {rid} [label="{label}"];')
        lines.append(f"  root -> {rid};")
    lines.append("}")
    return "\n".join(lines)


class CircuitLayout:
    """Region/cell occupancy map (dev/graph/layout.rs:39-85)."""

    def __init__(self, k: int, circuit, instance=None, fs=None):
        self.prover = MockProver.run(k, circuit, instance or [], fs=fs)

    def render_text(self) -> str:
        out = []
        cs = self.prover.cs
        out.append(f"columns: instance={cs.num_instance_columns} "
                   f"advice={cs.num_advice_columns} "
                   f"fixed={cs.num_fixed_columns}")
        for region in self.prover.regions:
            rows = region.rows or (0, -1)
            cols = sorted((getattr(c, "column_type", "selector"),
                           getattr(c, "index", None))
                          for c in region.columns)
            out.append(f"region {region.index} '{region.name}': "
                       f"rows [{rows[0]}, {rows[1]}] columns {cols}")
        return "\n".join(out)

    def render_svg(self, cell_size: int = 10) -> str:
        """Minimal SVG visualization of region placement."""
        cs = self.prover.cs
        ncols = (cs.num_instance_columns + cs.num_advice_columns
                 + cs.num_fixed_columns)
        nrows = max((r.rows[1] + 1) for r in self.prover.regions
                    if r.rows) if self.prover.regions else 1
        w, h = ncols * cell_size, nrows * cell_size
        parts = [f'<svg xmlns="http://www.w3.org/2000/svg" '
                 f'width="{w}" height="{h}">']
        colors = ["#8dd3c7", "#ffffb3", "#bebada", "#fb8072", "#80b1d3"]
        for region in self.prover.regions:
            if not region.rows:
                continue
            color = colors[region.index % len(colors)]
            y = region.rows[0] * cell_size
            hh = (region.rows[1] - region.rows[0] + 1) * cell_size
            parts.append(
                f'<rect x="0" y="{y}" width="{w}" height="{hh}" '
                f'fill="{color}" fill-opacity="0.5">'
                f'<title>{region.name}</title></rect>')
        parts.append("</svg>")
        return "".join(parts)


class TracingLayouter:
    """Span-emitting wrapper around an Assignment sink: logs every region
    entry/exit and assignment (the TracingFloorPlanner analogue,
    dev/tfp.rs:78-478), to a Python logger."""

    def __init__(self, inner, logger=None):
        import logging
        self.inner = inner
        self.log = logger or logging.getLogger("halo2_tpu_torch.tfp")

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr):
            return attr

        def wrapped(*args, **kwargs):
            self.log.debug("%s%r", name, args[:2])
            return attr(*args, **kwargs)
        return wrapped
