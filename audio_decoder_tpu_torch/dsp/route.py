"""Channel routing: mixdown / fan-out as one batched product.

The reference's only channel conversion is a mono→stereo fan-out hack in
the voice loop (engine.rs:419-427).  Here any C_in → C_out conversion is
a routing matrix applied as ``pcm @ m`` in full f32 (the package turns
TF32 off at import), then clipped like the mix path.

It is the port of the JAX package's ``dsp/route.py``; ``routing_matrix``
is a verbatim copy (it is numpy only).
"""

from __future__ import annotations

import numpy as np
import torch


def routing_matrix(c_in: int, c_out: int) -> np.ndarray:
    """Default conversion matrix [c_in, c_out]:

    * c_in == c_out: identity;
    * mono → N: fan-out (copy to every output, engine.rs:419-427);
    * N → mono: equal-weight downmix (1/N each);
    * stereo → N>2: L/R to the first two, silence above;
    * N → M otherwise: identity on the overlap, extra inputs folded into
      the last output at equal weight.
    """
    m = np.zeros((c_in, c_out))
    if c_in == c_out:
        np.fill_diagonal(m, 1.0)
    elif c_in == 1:
        m[0, :] = 1.0
    elif c_out == 1:
        m[:, 0] = 1.0 / c_in
    else:
        k = min(c_in, c_out)
        for i in range(k):
            m[i, i] = 1.0
        if c_in > c_out:
            extra = c_in - k
            m[k:, c_out - 1] = 1.0 / (extra + 1)
            m[c_out - 1, c_out - 1] = 1.0 / (extra + 1)
    return m


def route_channels(
    pcm, out_channels: int, matrix: np.ndarray | None = None, *,
    device="cuda",
) -> torch.Tensor:
    """pcm [B, S, C_in] → [B, S, out_channels] on ``device`` through a
    routing matrix (default: routing_matrix), clipped to [-1, 1] like the
    mix path."""
    from ..codecs.registry import resolve_device

    pcm = torch.as_tensor(pcm, device=resolve_device(device))
    c_in = pcm.shape[-1]
    m = routing_matrix(c_in, out_channels) if matrix is None else matrix
    out = torch.matmul(pcm, torch.as_tensor(np.asarray(m), dtype=pcm.dtype,
                                            device=pcm.device))
    return torch.clamp(out, -1.0, 1.0)
