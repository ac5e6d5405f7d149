"""Weight trees: what the harness does with one whatever its architecture.
The architecture's module makes them (``reference/<module>.py::
make_weights``), from the seed, on the device; the harness walks and
copies them here.  The vocabulary is padded as the port pads it.
"""

from __future__ import annotations

VOCAB_ALIGN = 512


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_ALIGN) * VOCAB_ALIGN


def leaves(tree, prefix=""):
    """(path, tensor) pairs of a tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to each leaf, its structure kept."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)
