"""Pixel-chunked execution of wavefront stages.

A ReSTIR frame keeps dozens of per-ray temporaries alive at once (every
candidate's sample, pdf and shade terms); over a whole 1080p frame (2.07M
rays) they take many GiB of device memory.  Large batches are therefore
processed in fixed-size pixel chunks with ``lax.map`` — per-chunk
temporaries stay small while cross-pixel gathers still address
full-image arrays through closures.  Whether the chunking still pays at
1080p on the card is an open measurement (ROADMAP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_CHUNK = 65536  # 256² — known-good working set


def map_chunks(fn, args: tuple, chunk: int = DEFAULT_CHUNK):
    """Apply ``fn`` over leading-axis chunks of every array in ``args``.

    ``fn(*chunk_args) -> pytree of arrays with the same leading size``.
    B is padded to a chunk multiple (fn must tolerate padded lanes — ray
    pads carry zero directions and are masked downstream by miss lanes).
    """
    b = args[0].shape[0]
    if b <= chunk:
        return fn(*args)

    if isinstance(args[0], (list, tuple)) or type(args[0]).__module__ == "numpy":
        # numpy (oracle) path: plain Python loop over chunks
        import numpy as np

        outs = []
        for s in range(0, b, chunk):
            outs.append(fn(*(a[s:s + chunk] for a in args)))
        return jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs, axis=0), *outs)

    pad = (-b) % chunk
    n = (b + pad) // chunk

    def prep(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((n, chunk) + x.shape[1:])

    stacked = tuple(prep(a) for a in args)
    out = jax.lax.map(lambda xs: fn(*xs), stacked)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((n * chunk,) + x.shape[2:])[:b], out)
