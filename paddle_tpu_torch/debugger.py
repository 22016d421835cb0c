"""Program visualization (counterpart of paddle_tpu/debugger.py): a
Program's op/var graph as Graphviz dot, for debugging."""
from __future__ import annotations

from typing import Optional


def _esc(s: str) -> str:
    return s.replace('"', '\\"')


def draw_block_graphviz(block, path: Optional[str] = None, highlights=None) -> str:
    """Render one block as dot: ellipse nodes for vars, boxes for ops."""
    highlights = set(highlights or ())
    lines = ["digraph G {", "  rankdir=TB;"]
    seen_vars = set()

    def var_node(name):
        if name in seen_vars:
            return
        seen_vars.add(name)
        v = block._find_var_recursive(name)
        shape = getattr(v, "shape", None) if v is not None else None
        persist = getattr(v, "persistable", False) if v is not None else False
        label = f"{name}\\n{list(shape) if shape is not None else '?'}"
        style = 'style=filled, fillcolor="#ffe4b5"' if persist else 'style=filled, fillcolor="#e8e8e8"'
        if name in highlights:
            style = 'style=filled, fillcolor="#ff9999"'
        lines.append(f'  "v_{_esc(name)}" [label="{_esc(label)}", shape=ellipse, {style}];')

    for i, op in enumerate(block.ops):
        oid = f"op_{i}_{op.type}"
        lines.append(f'  "{oid}" [label="{_esc(op.type)}", shape=box, '
                     f'style=filled, fillcolor="#b3d9ff"];')
        for n in op.input_arg_names:
            var_node(n)
            lines.append(f'  "v_{_esc(n)}" -> "{oid}";')
        for n in op.output_arg_names:
            var_node(n)
            lines.append(f'  "{oid}" -> "v_{_esc(n)}";')
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot


def draw_program(program, path_prefix: Optional[str] = None):
    """Dump every block of a Program; returns {block_idx: dot}."""
    out = {}
    for blk in program.blocks:
        p = f"{path_prefix}.block{blk.idx}.dot" if path_prefix else None
        out[blk.idx] = draw_block_graphviz(blk, p)
    return out
